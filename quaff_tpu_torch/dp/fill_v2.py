"""K1, the banded pair-HMM score fill: the CUDA kernel, its plain-PyTorch
version, and the scoring entry the aligner calls.

Ported from quaff_tpu/dp/pallas_v2.py (fill_v2 -> _row_kernel -> _one_row,
with the prep of _prepare_device and the end reduction of
scores_v2_traceable).  For B pairs it fills the banded Viterbi (max) or
Forward (log-add-exp) recursion row by row and returns each pair's end
score plus the end maximum of each lane-packed strip:

  band_fill_reference   the plain version: a Python row loop over [B, W]
                        float32 tensors, mirroring _one_row step by step
  band_fill             the wrapper: csrc/band_fill.cu on a CUDA tensor,
                        the plain version on a CPU tensor
  scores_v2             prep + band_fill + the -inf mapping
                        (scores_v2_device / scores_v2_traceable)

Both versions share one input layout, made on the device by
`kernel_inputs` from a `to_device` batch:

  x_tok  [B, Lx] int8     ref tokens
  keys   [B, Ly, 4] int32 per read row: match k-mer, quality, read token,
                          indel k-mer context of the row
  meta   [B, 4] int32     x_len, y_len, has_qual, 0
  doff   [B, W] int32     the diagonal of each lane; D_SENTINEL on lanes
                          outside every strip or outside the envelope
  seg_start, seg_width [B, S] int32   the strips' lane ranges

Their output is [B + B*S] float32: the pair scores, then the per-strip
end maxima row-major, floored at NEG_INF (the float32 minimum) where no
path ends.  The TPU kernel's one-hot MXU lookups, roll gathers, sliding
token window and (8, 128) padding do not carry over: the card reads each
row's five emission values and each lane's ref token directly.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .engine import TABLE_NAMES, _shift_left, _shift_right
from .scores import ScoreTables

NEG_INF = float(np.finfo(np.float32).min)
# diagonal of lanes outside every strip: beyond any x index, so never valid
D_SENTINEL = 1 << 24


class V2Tables:
    """The score tables of one parameter set as float32 tensors on one
    device, in their natural layouts:

      match [4, Km, Q], match_noq [4, Km], insert [4, Q], insert_noq [4]
      ik [Ki, 4]  (m2m, m2i, m2d, m2e per indel k-mer context)
      trans [4]   (d2d, d2m, i2i, i2m)

    The transitions stay a tensor handed to the kernel at run time, never
    a compile-time constant: parameters change per EM iteration and per
    server job."""

    def __init__(self, arrays: Mapping, device="cpu"):
        def f32(a):
            return torch.as_tensor(
                np.ascontiguousarray(np.asarray(a, np.float32)), device=device
            )

        self.match = f32(arrays["match_score"])
        self.match_noq = f32(arrays["match_score_noq"])
        self.insert = f32(arrays["insert_score"])
        self.insert_noq = f32(arrays["insert_score_noq"])
        self.ik = f32(np.stack(
            [np.asarray(arrays[k], np.float32)
             for k in ("m2m", "m2i", "m2d", "m2e")],
            axis=1,
        ))
        self.trans = f32([float(np.asarray(arrays[k]))
                          for k in ("d2d", "d2m", "i2i", "i2m")])
        self.n_ik = int(self.ik.shape[0])

    @classmethod
    def from_tables(cls, tables: ScoreTables, device="cpu") -> "V2Tables":
        return cls({k: getattr(tables, k) for k in TABLE_NAMES}, device)


def tables_from_reference(arrays: Mapping, device="cpu") -> V2Tables:
    """A port V2Tables from the JAX package's tables
    (quaff_tpu.dp.engine.device_tables values, as numpy), so a test can
    feed both sides identical numbers."""
    return V2Tables({k: np.asarray(v) for k, v in arrays.items()}, device)


def batch_max_prop(batch) -> "int | None":
    """Del-scan reach for a host PairBatch: the max lane-packed strip
    width, rounded up to a power of two.  None for non-packed batches
    (full-width scan)."""
    sw = getattr(batch, "seg_width", None)
    if sw is None:
        return None
    m = int(np.max(sw))
    if m <= 0:
        return None
    p = 1
    while p < m:
        p *= 2
    return p


def kernel_inputs(batch: dict) -> dict:
    """The shared K1 input layout (module docstring) from a `to_device`
    batch dict, computed on the batch's device."""
    member = batch["member"].bool()
    dev = member.device
    B, W = member.shape
    lane = torch.arange(W, device=dev, dtype=torch.int32)[None, :]
    if "seg_d_lo" in batch:
        seg_d_lo = batch["seg_d_lo"].int()
        seg_start = batch["seg_start"].int()
        seg_width = batch["seg_width"].int()
        doff = torch.full((B, W), D_SENTINEL, dtype=torch.int32, device=dev)
        for k in range(seg_d_lo.shape[1]):
            start = seg_start[:, k : k + 1]
            wk = seg_width[:, k : k + 1]
            in_seg = (wk > 0) & (lane >= start) & (lane < start + wk)
            doff = torch.where(in_seg, seg_d_lo[:, k : k + 1] + lane - start,
                               doff)
    else:
        # single-window batch: one strip spanning the whole width
        doff = batch["d_lo"].int()[:, None] + lane
        seg_start = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        seg_width = torch.full((B, 1), W, dtype=torch.int32, device=dev)
    doff = torch.where(member, doff, D_SENTINEL).int()
    keys = torch.stack(
        [
            batch["y_match_kmer"].int(),
            batch["y_qual"].int(),
            batch["y_tok"].int(),
            batch["y_indel_kmer_pad"][:, 1:].int(),
        ],
        dim=2,
    )
    meta = torch.stack(
        [
            batch["x_len"].int(),
            batch["y_len"].int(),
            batch["y_has_qual"].int(),
            torch.zeros(B, dtype=torch.int32, device=dev),
        ],
        dim=1,
    )
    return {
        "x_tok": batch["x_tok"].to(torch.int8).contiguous(),
        "keys": keys.contiguous(),
        "meta": meta.contiguous(),
        "doff": doff.contiguous(),
        "seg_start": seg_start.contiguous(),
        "seg_width": seg_width.contiguous(),
    }


def _lse2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """pallas_v2._lse2_fast: log-add-exp with one guard for two operands
    near -inf (a float32-minimum sentinel sum can overflow to -inf, and
    -inf - -inf would turn the formula into NaN)."""
    m = torch.maximum(a, b)
    r = m + torch.log1p(torch.exp(-(a - b).abs()))
    return torch.where(m < -1e38, m, r)


def band_fill_reference(x_tok, keys, meta, doff, seg_start, seg_width,
                        tables: V2Tables, mode: str = "viterbi",
                        local: bool = True, max_prop=None) -> torch.Tensor:
    """The plain PyTorch version of K1 on the packed layout: returns the
    raw [B + B*S] float32 pair scores and strip maxima."""
    viterbi = mode == "viterbi"
    combine = torch.maximum if viterbi else _lse2
    neg = NEG_INF
    B, W = doff.shape
    Ly = keys.shape[1]
    dev = doff.device
    f32 = torch.float32

    xt = x_tok.long()
    Lx = xt.shape[1]
    x_len = meta[:, 0:1].long()
    y_len = meta[:, 1:2].long()
    has_q = meta[:, 2].bool()
    doffl = doff.long()
    not_sent = doff != D_SENTINEL
    d2d, d2m, i2i, i2m = tables.trans.unbind(0)
    if tables.n_ik == 1:
        # gap order 0: one indel context, transitions are scalars
        m2m, m2i, m2d, m2e = tables.ik[0].unbind(0)
    ik_prev = torch.zeros(B, dtype=torch.long, device=dev)
    reach = W if max_prop is None else min(int(max_prop), W)

    mat = torch.full((B, W), neg, dtype=f32, device=dev)
    ins = mat.clone()
    dele = mat.clone()
    out = mat.clone()
    for j in range(1, Ly + 1):
        mk, q, yt, ik_cur = keys[:, j - 1].long().unbind(1)
        if tables.n_ik != 1:
            m2m = tables.ik[ik_prev, 0][:, None]
            m2i = tables.ik[ik_prev, 1][:, None]
            m2d = tables.ik[ik_cur, 2][:, None]
            m2e = tables.ik[ik_cur, 3][:, None]
        emit4 = torch.where(has_q[:, None], tables.match[:, mk, q].T,
                            tables.match_noq[:, mk].T)  # [B, 4]
        ins_emit = torch.where(has_q, tables.insert[yt, q],
                               tables.insert_noq[yt])[:, None]

        idx = doffl + (j - 1)  # i - 1 per lane
        valid = not_sent & (idx >= 0) & (idx < x_len) & (j <= y_len)
        tok = torch.gather(xt, 1, idx.clamp(0, Lx - 1))
        emit = torch.gather(emit4, 1, tok)

        mat_c = combine(combine(mat + m2m, dele + d2m), ins + i2m)
        if j == 1:
            start_ok = torch.ones_like(valid) if local else idx == 0
        else:
            start_ok = torch.zeros_like(valid)
        mat_c = combine(mat_c, torch.where(start_ok, 0.0, neg))
        mat_c = torch.where(valid, mat_c + emit, neg)

        ins_c = ins_emit + combine(
            _shift_left(ins, neg) + i2i, _shift_left(mat, neg) + m2i
        )
        ins_c = torch.where(valid, ins_c, neg)

        # delete chain: halo lanes set c = -inf, which stops the scan
        # crossing strip seams, so a reach of the widest strip suffices
        c_vec = torch.where(valid, d2d, neg)
        b_vec = torch.where(valid, _shift_right(mat_c, 1, neg) + m2d, neg)
        s = 1
        while s < reach:
            b_vec = combine(_shift_right(b_vec, s, neg) + c_vec, b_vec)
            c_vec = _shift_right(c_vec, s, 0.0) + c_vec
            s *= 2
        del_c = torch.where(valid, b_vec, neg)

        end_ok = valid & (j == y_len)
        if not local:
            end_ok &= idx == x_len - 1
        out = combine(out, torch.where(end_ok, mat_c + m2e, neg))

        mat, ins, dele = mat_c, ins_c, del_c
        ik_prev = ik_cur

    lane = torch.arange(W, device=dev)[None, None, :]
    lo = seg_start.long()[:, :, None]
    in_seg = (lane >= lo) & (lane < lo + seg_width.long()[:, :, None])
    segmax = torch.where(in_seg, out[:, None, :], neg).amax(dim=2)
    if viterbi:
        score = out.amax(dim=1)
    else:
        m = out.amax(dim=1)
        safe = torch.where(torch.isfinite(m), m, 0.0)
        score = safe + torch.log(torch.exp(out - safe[:, None]).sum(dim=1))
        score = torch.where(torch.isfinite(m), score, float("-inf"))
    return torch.cat([score, segmax.reshape(-1)])


def band_fill(x_tok, keys, meta, doff, seg_start, seg_width,
              tables: V2Tables, mode: str = "viterbi", local: bool = True,
              max_prop=None) -> torch.Tensor:
    """K1 on the tensors' device: csrc/band_fill.cu for CUDA tensors (each
    launch adds one to `band_fill.launches`), the plain version for CPU
    tensors.  Same inputs and [B + B*S] float32 output for both.

    max_prop bounds the plain version's shift-scan steps; the kernel's
    delete scan is sequential inside a thread and a tree across threads,
    which covers the whole row at any reach."""
    dev = doff.device
    if dev.type == "cpu":
        return band_fill_reference(x_tok, keys, meta, doff, seg_start,
                                   seg_width, tables, mode, local, max_prop)
    if dev.type != "cuda":
        raise RuntimeError(f"band_fill: no kernel for device {dev}")
    from .. import kernels

    B, W = doff.shape
    S = seg_start.shape[1]
    Ly = keys.shape[1]
    Lx = x_tok.shape[1]
    tensors = {
        "x_tok": (x_tok, torch.int8, (B, Lx)),
        "keys": (keys, torch.int32, (B, Ly, 4)),
        "meta": (meta, torch.int32, (B, 4)),
        "doff": (doff, torch.int32, (B, W)),
        "seg_start": (seg_start, torch.int32, (B, S)),
        "seg_width": (seg_width, torch.int32, (B, S)),
        "match": (tables.match, torch.float32, None),
        "match_noq": (tables.match_noq, torch.float32, None),
        "insert": (tables.insert, torch.float32, None),
        "insert_noq": (tables.insert_noq, torch.float32, None),
        "ik": (tables.ik, torch.float32, (tables.n_ik, 4)),
        "trans": (tables.trans, torch.float32, (4,)),
    }
    for name, (t, dt, shape) in tensors.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"band_fill: {name} must be a contiguous {dt} tensor on "
                f"{dev} (got {t.dtype} on {t.device})"
            )
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"band_fill: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    out = torch.empty(B + B * S, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        lib = kernels.library()
        smem_lanes = kernels.max_smem_lanes(dev.index or 0)
        scratch = None
        if W > smem_lanes:
            # row state too wide for shared memory: a global scratch row
            # set per pair (6 words per lane, see band_fill.cu)
            scratch = torch.empty(B * 6 * W, dtype=torch.float32, device=dev)
        err = lib.quaff_band_fill(
            x_tok.data_ptr(), Lx, keys.data_ptr(), Ly, meta.data_ptr(),
            doff.data_ptr(), W, seg_start.data_ptr(), seg_width.data_ptr(), S,
            tables.match.data_ptr(), tables.match_noq.data_ptr(),
            tables.insert.data_ptr(), tables.insert_noq.data_ptr(), Km, Q,
            tables.ik.data_ptr(), tables.n_ik, tables.trans.data_ptr(),
            B, int(mode == "viterbi"), int(bool(local)),
            0 if scratch is None else scratch.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"band_fill kernel launch failed: {kernels.error_string(err)} "
            f"(B={B}, W={W}, Ly={Ly})"
        )
    band_fill.launches += 1
    return out


band_fill.launches = 0


def scores_v2(v2tab: V2Tables, batch: dict, mode: str = "viterbi",
              local: bool = True, return_segments: bool = False,
              defer_fetch: bool = False, max_prop=None):
    """Pair end scores for a `to_device` batch on `v2tab`'s device
    (quaff_tpu's scores_v2_device).

    Returns float64 numpy scores [B], -inf where no path ends.  With
    return_segments=True (lane-packed batches, Viterbi) also the per-strip
    end maxima [B, S] in pack_strips order; with defer_fetch=True the
    unfetched device tensor ([B + B*S] with segments, else [B]) instead,
    so a caller can enqueue more chunks before it waits."""
    if return_segments:
        if "seg_start" not in batch:
            raise ValueError("return_segments needs a lane-packed batch")
        if mode != "viterbi":
            raise ValueError("return_segments is Viterbi-only")
    inp = kernel_inputs(batch)
    raw = band_fill(**inp, tables=v2tab, mode=mode, local=local,
                    max_prop=max_prop)
    B, S = inp["seg_start"].shape
    packed = torch.where(raw <= NEG_INF / 2, float("-inf"), raw)
    if not return_segments:
        packed = packed[:B]
    if defer_fetch:
        return packed
    host = packed.cpu().numpy().astype(np.float64)
    if return_segments:
        return host[:B], host[B:].reshape(B, S)
    return host
