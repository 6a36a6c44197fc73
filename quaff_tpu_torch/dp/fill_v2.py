"""K1, the banded pair-HMM score fill: the CUDA kernel, its plain-PyTorch
version, and the scoring entry the aligner calls.

Ported from quaff_tpu/dp/pallas_v2.py (fill_v2 -> _row_kernel -> _one_row,
with the prep of _prepare_device and the end reduction of
scores_v2_traceable).  For B pairs it fills the banded Viterbi (max) or
Forward (log-add-exp) recursion row by row and returns each pair's end
score plus the end maximum of each lane-packed strip:

  band_fill_reference   the plain version: a Python row loop over [B, W]
                        float32 tensors, mirroring _one_row step by step
  band_fill             the wrapper: csrc/band_fill.cu on a CUDA tensor
                        (the warp route for bands of up to 32 * 16 lanes,
                        the cluster route up to FILL_CLUSTER_MAX_LANES, the
                        block route for wider ones: fill_route), the plain
                        version on a CPU tensor
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
# lanes a thread of K1's warp route (the instantiations of
# csrc/band_fill_warp.cuh); a warp covers 32 * lpt lanes
WARP_LPTS = (1, 2, 4, 8, 16)
# K1's cluster route (csrc/band_fill_cluster.cuh): a pair's band tiled over
# the warps of a thread-block cluster, 32 * lpt lanes a tile, at most
# MAX_TILES tiles and MAX_CLUSTER_CTAS CTAs (the card's portable cluster
# size); lanes a thread of its instantiations, and the warps a CTA each
# may have (its registers: 255 a thread at 8 warps, 128 at 16)
MAX_TILES = 32
MAX_CLUSTER_CTAS = 8
FILL_CLUSTER_LPTS = (4, 8, 16)
# The cluster route's tiling by width: (widest band, lanes a thread, warps
# a CTA at most), the first row that covers W; the tiles spread evenly over
# the fewest CTAs that hold them (cluster_tiling).  Each row is the fastest
# tiling that holds K1's tolerance against the plain version (rtol 1e-5 /
# atol 1e-3) on the cluster-route cases of chip_smoke.py phases 2 and 4,
# from their sweep of every tiling (median of 3; NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md §6):
#   - 1101 lanes (global, 300 rows): 1 x 9 x 4 0.405 ms, the fastest (the
#     next 1 x 5 x 8 0.465);
#   - 4038 lanes (phase 4's chunk, reads of up to 8598 rows): 1 x 16 x 8
#     15.421 ms.  1 x 8 x 16 took 14.620, but it and every other tiling of
#     16 lanes a thread are 0.445 off the plain version there, outside the
#     tolerance (0.35 at these scores); 8 lanes a thread are 0.355 off, 4
#     lanes 0.223.  The error is the order of the float32 sums: every one of
#     these fills, the plain version's too, is 1.99 off the plain version
#     run in float64, so none is nearer the exact score.  One CTA beat every
#     multi-CTA tiling (the fastest 4 x 4 x 8, 17.896) and the block route
#     (31.417);
#   - 12070 lanes (400 rows): 6 x 4 x 16 1.062 ms against 1.374 for 3 x 8 x
#     16; past 8192 lanes only 16 lanes a thread cover the band in 32 tiles.
FILL_CLUSTER_TABLE = ((2048, 4, 16), (8192, 8, 16), (16384, 16, 4))
# the widest band the cluster route takes; wider ones take the block route
FILL_CLUSTER_MAX_LANES = FILL_CLUSTER_TABLE[-1][0]


def fill_cluster_max_warps(lpt: int) -> int:
    """Warps a CTA of K1's cluster route may have at lpt lanes a thread."""
    return 8 if lpt >= 16 else 16


def cluster_tiling(W: int, table) -> tuple:
    """(CTAs a pair, warps a CTA, lanes a thread) of a cluster route for a
    band of W lanes from its (widest band, lpt, warps a CTA at most) table:
    the tiles of 32 * lpt lanes that cover the band, over the fewest CTAs
    that hold them, spread evenly."""
    for widest, lpt, cap in table:
        if W <= widest:
            tiles = -(-W // (32 * lpt))
            nct = -(-tiles // cap)
            return nct, -(-tiles // nct), lpt
    raise ValueError(f"no cluster tiling covers a band of {W} lanes")


def cluster_route_ok(W: int, tiling, lpts, max_warps) -> bool:
    """Whether a cluster tiling (nct, warps, lpt) is one the kernel has and
    covers W lanes, in a cluster of at most MAX_CLUSTER_CTAS CTAs."""
    try:
        nct, warps, lpt = (int(v) for v in tiling)
    except (TypeError, ValueError):
        return False
    return (lpt in lpts and 1 <= nct <= MAX_CLUSTER_CTAS
            and 1 <= warps <= max_warps(lpt) and nct * warps <= MAX_TILES
            and W <= 32 * lpt * warps * nct)


def fill_route(W: int) -> tuple:
    """K1's route for a band of W lanes, a function of W alone: ("warp",
    lpt) with the smallest lpt of WARP_LPTS whose warp covers the band
    (32 * lpt >= W); past 32 * 16 lanes ("cluster", (nct, warps, lpt)) of
    cluster_tiling up to FILL_CLUSTER_MAX_LANES; ("block", 0) past it: one
    block per pair."""
    for lpt in WARP_LPTS:
        if 32 * lpt >= W:
            return "warp", lpt
    if W <= FILL_CLUSTER_MAX_LANES:
        return "cluster", cluster_tiling(W, FILL_CLUSTER_TABLE)
    return "block", 0


def _fill_route_ok(W: int, route) -> bool:
    kind, arg = route
    if kind == "warp":
        return arg in WARP_LPTS and W <= 32 * arg
    if kind == "cluster":
        return cluster_route_ok(W, arg, FILL_CLUSTER_LPTS,
                                fill_cluster_max_warps)
    return kind == "block" and arg == 0


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
                        local: bool = True, max_prop=None,
                        rows=None, offsets=None,
                        dtype=torch.float32) -> torch.Tensor:
    """The plain PyTorch version of K1 on the packed layout: returns the
    raw [B + B*S] float32 pair scores and strip maxima.  With dtype
    torch.float64 the row cells and sums are float64 (the float32 tables'
    values, added without float32 rounding) and so is the output: a
    witness of how far a float32 fill drifts.

    With `rows` ([3, B, Ly, W] float32) and `offsets` ([B, Ly] float64),
    K2's store, the Forward fill is kept scaled: after each row its largest
    cell is subtracted from the row's cells and added to the pair's
    float64 offset, every row's match, insert and delete cells are stored
    relative to that row's offset, and the pair scores come back absolute.
    A float32 fill of unscaled log-probabilities drifts: at -2e4 nats a
    float32 step is 2e-3 and small log-add-exp terms round away, enough
    over the 6604-row c8f30 read to move its printed log-likelihood."""
    viterbi = mode == "viterbi"
    combine = torch.maximum if viterbi else _lse2
    neg = NEG_INF
    B, W = doff.shape
    Ly = keys.shape[1]
    dev = doff.device
    f32 = dtype

    xt = x_tok.long()
    Lx = xt.shape[1]
    x_len = meta[:, 0:1].long()
    y_len = meta[:, 1:2].long()
    has_q = meta[:, 2].bool()
    doffl = doff.long()
    not_sent = doff != D_SENTINEL
    d2d, d2m, i2i, i2m = tables.trans.to(f32).unbind(0)
    ik = tables.ik.to(f32)
    if tables.n_ik == 1:
        # gap order 0: one indel context, transitions are scalars
        m2m, m2i, m2d, m2e = ik[0].unbind(0)
    ik_prev = torch.zeros(B, dtype=torch.long, device=dev)
    reach = W if max_prop is None else min(int(max_prop), W)

    mat = torch.full((B, W), neg, dtype=f32, device=dev)
    ins = mat.clone()
    dele = mat.clone()
    out = mat.clone()
    off = torch.zeros(B, dtype=torch.float64, device=dev)
    for j in range(1, Ly + 1):
        mk, q, yt, ik_cur = keys[:, j - 1].long().unbind(1)
        if tables.n_ik != 1:
            m2m = ik[ik_prev, 0][:, None]
            m2i = ik[ik_prev, 1][:, None]
            m2d = ik[ik_cur, 2][:, None]
            m2e = ik[ik_cur, 3][:, None]
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

        if rows is not None:
            top = torch.maximum(torch.maximum(mat_c, ins_c), del_c).amax(1)
            shift = torch.where(top > neg / 2, top, 0.0)[:, None]
            mat_c = torch.where(valid, mat_c - shift, neg)
            ins_c = torch.where(valid, ins_c - shift, neg)
            del_c = torch.where(valid, del_c - shift, neg)
            out = torch.where(out > neg / 2, out - shift, neg)
            off = off + shift[:, 0].double()
            offsets[:, j - 1] = off
            rows[0, :, j - 1] = mat_c
            rows[1, :, j - 1] = ins_c
            rows[2, :, j - 1] = del_c
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
        if rows is not None:
            score = torch.where(score > neg / 2, (off + score.double()).float(),
                                score)
    return torch.cat([score, segmax.reshape(-1)])


def check_tensors(name, tensors, dev):
    """What a kernel takes: each {key: (tensor, dtype, shape or None)} must
    be a contiguous tensor of that dtype and shape on `dev`."""
    for key, (t, dt, shape) in tensors.items():
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {key} must be a contiguous {dt} tensor on {dev} "
                f"(got {t.dtype} on {t.device})"
            )
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def table_specs(tables: V2Tables) -> dict:
    """check_tensors specs of the score tables."""
    return {
        "match": (tables.match, torch.float32, None),
        "match_noq": (tables.match_noq, torch.float32, None),
        "insert": (tables.insert, torch.float32, None),
        "insert_noq": (tables.insert_noq, torch.float32, None),
        "ik": (tables.ik, torch.float32, (tables.n_ik, 4)),
        "trans": (tables.trans, torch.float32, (4,)),
    }


def launch_args(x_tok, keys, meta, doff, seg_start, seg_width,
                tables: V2Tables, mode: str, local: bool) -> tuple:
    """The arguments every K1 entry of csrc/band_fill.cu takes first (its
    route's own and the output follow)."""
    B, W = doff.shape
    return (
        x_tok.data_ptr(), x_tok.shape[1], keys.data_ptr(), keys.shape[1],
        meta.data_ptr(), doff.data_ptr(), W, seg_start.data_ptr(),
        seg_width.data_ptr(), seg_start.shape[1],
        tables.match.data_ptr(), tables.match_noq.data_ptr(),
        tables.insert.data_ptr(), tables.insert_noq.data_ptr(),
        tables.match.shape[1], tables.match.shape[2],
        tables.ik.data_ptr(), tables.n_ik, tables.trans.data_ptr(),
        B, int(mode == "viterbi"), int(bool(local)),
    )


def band_fill(x_tok, keys, meta, doff, seg_start, seg_width,
              tables: V2Tables, mode: str = "viterbi", local: bool = True,
              max_prop=None, route=None) -> torch.Tensor:
    """K1 on the tensors' device: csrc/band_fill.cu for CUDA tensors, on
    the route fill_route picks from the band's width (each launch adds one
    to `band_fill.launches` and to `warp_launches`, `cluster_launches` or
    `block_launches`), the plain version for CPU tensors.  Same inputs and
    [B + B*S] float32 output for all.  A failed launch, or a cluster shape
    the card refuses, raises on every route; none gives way to another.

    route, ("warp", lpt), ("cluster", (nct, warps, lpt)) or ("block", 0),
    launches that route instead, for holding the routes against each other
    on the same inputs; it must cover the band.

    max_prop bounds the plain version's shift-scan steps; the kernels'
    delete scans are sequential inside a thread and a tree across threads,
    which covers the whole row at any reach."""
    B, W = doff.shape
    if route is None:
        route = fill_route(W)
    if not _fill_route_ok(W, route):
        raise ValueError(f"band_fill: no route {route} for a band of {W} "
                         f"lanes")
    dev = doff.device
    if dev.type == "cpu":
        return band_fill_reference(x_tok, keys, meta, doff, seg_start,
                                   seg_width, tables, mode, local, max_prop)
    if dev.type != "cuda":
        raise RuntimeError(f"band_fill: no kernel for device {dev}")
    from .. import kernels

    S = seg_start.shape[1]
    Ly = keys.shape[1]
    Lx = x_tok.shape[1]
    check_tensors("band_fill", {
        "x_tok": (x_tok, torch.int8, (B, Lx)),
        "keys": (keys, torch.int32, (B, Ly, 4)),
        "meta": (meta, torch.int32, (B, 4)),
        "doff": (doff, torch.int32, (B, W)),
        "seg_start": (seg_start, torch.int32, (B, S)),
        "seg_width": (seg_width, torch.int32, (B, S)),
        **table_specs(tables),
    }, dev)
    out = torch.empty(B + B * S, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    kind, arg = route
    with torch.cuda.device(dev):
        lib = kernels.library()
        args = launch_args(x_tok, keys, meta, doff, seg_start, seg_width,
                           tables, mode, local)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "warp":
            err = lib.quaff_band_fill_warp(*args, arg, out.data_ptr(), stream)
        elif kind == "cluster":
            nct, warps, lpt = arg
            err = lib.quaff_band_fill_cluster(*args, lpt, nct, warps,
                                              out.data_ptr(), stream)
        else:
            scratch = None
            if W > kernels.max_smem_lanes(dev.index or 0):
                # row state too wide for shared memory: a global scratch
                # row set per pair (6 words per lane, see band_fill.cuh)
                scratch = torch.empty(B * 6 * W, dtype=torch.float32,
                                      device=dev)
            err = lib.quaff_band_fill(
                *args, 0 if scratch is None else scratch.data_ptr(),
                out.data_ptr(), stream)
    kernels.check_launch(err, "band_fill", route, f"B={B}, W={W}, Ly={Ly}")
    band_fill.launches += 1
    setattr(band_fill, f"{kind}_launches",
            getattr(band_fill, f"{kind}_launches") + 1)
    return out


band_fill.launches = 0
band_fill.warp_launches = 0
band_fill.cluster_launches = 0
band_fill.block_launches = 0


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
