"""K4, the read-vs-read overlap Viterbi score fill: the CUDA kernel, its
plain-PyTorch version, and the scoring entry the overlap pipeline calls.

Ported from quaff_tpu/dp/pallas_overlap.py (_ov_fill -> _ov_kernel, with
the prep of _ov_tabs / _ov_prepare_device and the end reduction of
_ov_reduce_segments).  For B (read x, read y) pairs it fills the banded
overlap Viterbi recursion (dp/overlap.py's model) row by row and returns
each pair's score plus the end maximum of each lane-packed strip:

  ov_fill_reference   the plain version: a Python row loop over [B, W]
                      float32 tensors, mirroring _ov_kernel step by step
                      (its doubling scan of the delete chain included)
  ov_fill             the wrapper: csrc/ov_fill.cu on a CUDA tensor (the
                      warp route for bands of up to OV_WARP_MAX_LANES, the
                      cluster route for wider ones up to OV_LANE_CAP:
                      ov_route), the plain version on a CPU tensor
  overlap_scores      prep + ov_fill (overlap_scores_kernel)

The pair emission of a cell is recomputed from its definition, which
factorises over the marginalised reference symbol r (qoverlap.cpp:62-70):

  emit(i, j) = lse_r(logRB[r] + msX[r](i) + msY[r](j)) - insX(i) - insY(j)

Both versions read one input layout, made on the device by `prepare`:

  bank   [N, C, L] float32  one row per (read, side), C = 5 or 7 channels
         along the read: an x row holds logRB[r] + msX[r] (r = 0..3) and
         insX, a y row msY[r] (complement-folded through the strand's
         y_symbol_map) and insY; at gap order > 0 an x row adds the gap
         open and stay logs of position i, a y row open(j) and stay(j-1)
  meta   [B, 8] int32  x_row, y_row, x_len, y_len, j_off, n_rows, 0, 0:
         the pair's live rows are j_off+1 .. j_off+n_rows
  doff   [B, W] int32  each lane's diagonal; D_SENTINEL on lanes outside
         the envelope
  seg_start, seg_width [B, S] int32   the strips' lane ranges
  ins_xy [B, 2] float32  the pair's full-sequence x and y insert sums
  trans  [9] float32   m2m, m2i, m2d (gap order 0), i2m, i2i, i2d, d2m,
         d2i, d2d: data handed over at run time, never compiled in

Their output is [B + B*S] float32: the pair scores (end + x and y insert
sums), then the per-strip raw end maxima row-major, -inf where no path
ends.  The TPU kernel's rolling windows, streamed slot columns and roll
shifts exist because a TPU lane cannot gather; the card gathers each
lane's x values from the bank directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..alphabet import QUAL_SCORE_RANGE
from ..device import one_thread_on_cpu
from .engine import _shift_left, _shift_right
from .fill_v2 import (D_SENTINEL, NEG_INF, WARP_LPTS, _lse2, check_tensors,
                      cluster_route_ok, cluster_tiling)

MAX_SEGS = 3  # lane-packed strips per pair (more get merged)

# Widest packed band K4 takes.  Wider pairs go straight to the host's
# exact pass.  The cap is a constant, not a query of the card, because it
# decides which envelopes are re-banded and so the output text: the CPU
# and the card must agree.  (It was set by the block route's row state, 7
# float32 words a lane in a block's 227 KB of shared memory; the cluster
# route keeps it.)
OV_LANE_CAP = 8192

# Widest band K4's warp route takes (csrc/ov_fill_warp.cuh, one warp a
# pair, 32 * lpt lanes for lpt in WARP_LPTS); wider bands take the cluster
# route.  128: on the same inputs (chip_smoke.py phase 6, NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md) the warp route won at 126 lanes (its
# 630-pair chunk: 4 lanes a thread 14.478 ms against the cluster route's
# 17.399) and lost at 218 (its 73-pair chunk: 8 lanes a thread 27.727
# against 17.095) and at 455 (16 lanes a thread 52.047 against 19.503).
OV_WARP_MAX_LANES = 128

# K4's cluster route (csrc/ov_fill_cluster.cuh): a pair's band tiled over
# the warps of a thread-block cluster, 32 * lpt lanes a tile; lanes a
# thread of its instantiations, and its tiling by width: (widest band,
# lanes a thread, warps a CTA at most), the first row that covers W
# (fill_v2.cluster_tiling).  Set from chip_smoke.py phase 6's sweep of
# every tiling on each of its cluster-route chunks (median of 3, NVIDIA
# H100 80GB HBM3 at 700 W, PERF.md): the fastest was one CTA of up to 16
# warps at 2 lanes a thread up to 1024 lanes (825: 1 x 13 x 2 19.054 ms,
# against 21.330 for 4 x 4 x 2), and then CTAs of 4 warps at the fewest
# lanes a thread whose 32 tiles cover the band (1945: 8 x 4 x 2 18.728
# against 26.607 for 2 x 8 x 4; 3788: 8 x 4 x 4 31.960 against 34.100 for
# 4 x 8 x 4; 8063: 8 x 4 x 8 41.051 against 45.352 for 4 x 8 x 8).
OV_CLUSTER_LPTS = (2, 4, 8)
OV_CLUSTER_TABLE = ((1024, 2, 16), (2048, 2, 4), (4096, 4, 4),
                    (OV_LANE_CAP, 8, 4))


def ov_cluster_max_warps(lpt: int) -> int:
    """Warps a CTA of K4's cluster route may have at lpt lanes a thread
    (its registers: 255 a thread at 8 warps, 128 at 16)."""
    return 8 if lpt >= 8 else 16


# bank channels
CH_INS = 4  # insX / insY
CH_OPEN = 5  # open_x(i) / open_y(j)
CH_STAY = 6  # stay_x(i) / stay_y(j - 1)


class OvTables:
    """The small per-(params, strand) tables K4's prep gathers from, as
    float32 tensors on one device (_ov_tabs):

      msx [Km*Q, 4]  match score given ref symbol r, key k-mer*Q + quality
      msxn [Km, 4]   the same without qualities
      msy, msyn      msx, msxn complement-folded through y_symbol_map
      ins [4*Q], insn [4], log_rb [4]
      lgo, lg1m [Ki] gap open / stay logs (gap order > 0, else None)
      trans [9]      see the module docstring
    """

    def __init__(self, tables, device="cpu"):
        def f32(a):
            return torch.as_tensor(
                np.ascontiguousarray(np.asarray(a, np.float32)), device=device
            )

        Q = QUAL_SCORE_RANGE
        base = tables.base_tables
        msx = np.asarray(base.match_score, np.float32)  # [4, Km, Q]
        msx_n = np.asarray(base.match_score_noq, np.float32)  # [4, Km]
        y_map = np.asarray(tables.y_symbol_map)
        km = msx.shape[1]
        self.msx = f32(msx.transpose(1, 2, 0).reshape(km * Q, 4))
        self.msxn = f32(msx_n.T)
        self.msy = f32(msx[y_map].transpose(1, 2, 0).reshape(km * Q, 4))
        self.msyn = f32(msx_n[y_map].T)
        self.ins = f32(np.asarray(tables.insert_score).reshape(-1))
        self.insn = f32(tables.insert_score_noq)
        self.log_rb = f32(tables.log_ref_base)
        self.lgo = self.lg1m = None
        if tables.indel_kmer_len > 0:
            self.lgo = f32(tables.log_gap_open)
            self.lg1m = f32(tables.log_gap_stay)
        self.trans = f32([
            float(tables.m2m[0, 0]), float(tables.m2i[0, 0]),
            float(tables.m2d[0, 0]), tables.i2m_eff, tables.i2i_eff,
            tables.i2d_eff, tables.d2m_eff, tables.d2i_eff, tables.d2d_eff,
        ])


def ov_tables(tables, device) -> OvTables:
    """The OvTables of an OverlapScoreTables on `device`, cached on it."""
    device = torch.device(device)
    cache = tables.__dict__.setdefault("_ov_tables", {})
    if device not in cache:
        cache[device] = OvTables(tables, device)
    return cache[device]


def bank_rows(tabs: OvTables, side: str, tok, mk, ik, q, hq, lens):
    """Bank rows [N, C, L] float32 of N reads on one side ("x" or "y") from
    their [N, L] token, match k-mer, indel k-mer and quality codes, [N]
    has-quality flags and lengths, by gathers from the small tables.
    Positions at or past a read's length hold -inf match values and zero
    insert and gap values, as the TPU kernel's windows do."""
    Q = QUAL_SCORE_RANGE
    km = tabs.msxn.shape[0]
    tok, mk, q = tok.long(), mk.long().clamp(0, km - 1), q.long().clamp(0, Q - 1)
    hq = hq.bool()[:, None]
    N, L = tok.shape
    ms, msn = (tabs.msx, tabs.msxn) if side == "x" else (tabs.msy, tabs.msyn)
    v4 = torch.where(hq[..., None], ms[mk * Q + q], msn[mk])  # [N, L, 4]
    if side == "x":
        v4 = v4 + tabs.log_rb
    tokc = tok.clamp(0, 3)
    ins = torch.where(hq, tabs.ins[tokc * Q + q], tabs.insn[tokc])
    live = torch.arange(L, device=tok.device)[None, :] < lens.long()[:, None]
    chans = [torch.where(live, v4[..., r], NEG_INF) for r in range(4)]
    chans.append(torch.where(live, ins, 0.0))
    if tabs.lgo is not None:
        ki = tabs.lgo.shape[0]
        ik = ik.long().clamp(0, ki - 1)
        if side == "x":
            opens, stays = tabs.lgo[ik], tabs.lg1m[ik]
        else:
            # row j reads open at j and stay at j - 1 (the dummy context 0
            # at j = 1, as the reference's padded indel k-mer array has)
            prev = torch.cat([torch.zeros_like(ik[:, :1]), ik[:, :-1]], dim=1)
            opens, stays = tabs.lgo[ik], tabs.lg1m[prev]
        chans.append(torch.where(live, opens, 0.0))
        chans.append(torch.where(live, stays, 0.0))
    return torch.stack(chans, dim=1).contiguous()


def packed_overlap_descriptors(envs, x_lens, y_lens, max_segs: int = MAX_SEGS):
    """Lane-packed layout + live-row windows for a list of envelopes.

    Returns (member [B, Wp], seg_d_lo, seg_start, seg_width [B, S], j_off
    [B], rows [B]): each envelope's strips (merged to <= max_segs) side by
    side on the lane axis with their +-1 halos, and the row window
    [j_off+1, j_off+rows] outside which the pair has no in-envelope cells
    (member diagonal d covers rows 1-d .. x_len-d)."""
    from ..envelope import pack_strips

    B = len(envs)
    seg_d_lo = np.full((B, max_segs), D_SENTINEL, np.int32)
    seg_start = np.zeros((B, max_segs), np.int32)
    seg_width = np.zeros((B, max_segs), np.int32)
    j_off = np.zeros(B, np.int32)
    rows = np.zeros(B, np.int32)
    masks = []
    for b, env in enumerate(envs):
        segs = pack_strips(env, max_segs)
        lane = 0
        parts = []
        for k, s in enumerate(segs):
            seg_d_lo[b, k] = s.band_lo
            seg_start[b, k] = lane
            seg_width[b, k] = s.band_width
            lane += s.band_width
            parts.append(s.member_mask())
        masks.append(np.concatenate(parts))
        d1 = int(segs[0].diagonals[0])
        d2 = int(segs[-1].diagonals[-1])
        j0 = max(1, 1 - d2)
        j_off[b] = j0 - 1
        rows[b] = max(min(int(y_lens[b]), int(x_lens[b]) - d1) - j0 + 1, 1)
    Wp = max(len(m) for m in masks)
    member = np.zeros((B, Wp), bool)
    for b, m in enumerate(masks):
        member[b, : len(m)] = m
    return member, seg_d_lo, seg_start, seg_width, j_off, rows


def prepare(tabs: OvTables, batch: dict) -> dict:
    """K4's input layout (module docstring) from a chunk's tensors on one
    device (_ov_prepare_device): "bank" (bank_rows output, built once per
    run), the pairs' "x_row"/"y_row" indices into it, x_len, y_len, member,
    the lane-packed strips seg_d_lo/seg_start/seg_width, the live-row
    windows j_off/n_rows, and x_insert_score/y_insert_score."""
    member = batch["member"].bool()
    dev = member.device
    B, W = member.shape
    i32 = torch.int32
    seg_d_lo = batch["seg_d_lo"].to(i32)
    seg_start = batch["seg_start"].to(i32)
    seg_width = batch["seg_width"].to(i32)
    lane = torch.arange(W, device=dev, dtype=i32)[None, :]
    doff = torch.full((B, W), D_SENTINEL, dtype=i32, device=dev)
    for k in range(seg_d_lo.shape[1]):
        start = seg_start[:, k : k + 1]
        wk = seg_width[:, k : k + 1]
        in_seg = (wk > 0) & (lane >= start) & (lane < start + wk)
        doff = torch.where(in_seg, seg_d_lo[:, k : k + 1] + lane - start, doff)
    meta = torch.stack([batch[k].to(i32) for k in (
        "x_row", "y_row", "x_len", "y_len", "j_off", "n_rows")], dim=1)
    meta = torch.nn.functional.pad(meta, (0, 2))
    ins_xy = torch.stack([batch["x_insert_score"], batch["y_insert_score"]],
                         dim=1)
    return {
        "bank": batch["bank"],
        "meta": meta.contiguous(),
        "doff": torch.where(member, doff, D_SENTINEL).to(i32).contiguous(),
        "seg_start": seg_start.contiguous(),
        "seg_width": seg_width.contiguous(),
        "ins_xy": ins_xy.to(torch.float32).contiguous(),
        "trans": tabs.trans,
    }


def ov_fill_reference(bank, meta, doff, seg_start, seg_width, ins_xy,
                      trans) -> torch.Tensor:
    """The plain PyTorch version of K4: returns the [B + B*S] float32 pair
    scores and per-strip end maxima (module docstring).  Mirrors
    _ov_kernel's arithmetic row by row, including the Hillis-Steele scan
    of the delete chain's (c, k, b) triples and _lse2_fast's guard.  The
    scan stops at the longest run of envelope lanes instead of the whole
    row: a chain never crosses a lane outside the envelope (c = -inf), and
    past that reach every step leaves max(k, b) bit for bit as it was."""
    neg = NEG_INF
    B, W = doff.shape
    _, C, L = bank.shape
    dev = doff.device
    use_ik = C == 7
    flat = bank.reshape(-1)
    x_row, y_row, x_len, y_len, j_off, n_rows = meta[:, :6].long().unbind(1)
    x_len, y_len = x_len[:, None], y_len[:, None]
    m2m, m2i, m2d, i2m, i2i, i2d, d2m, d2i, d2d = trans.unbind(0)
    member = doff != D_SENTINEL
    d = doff.long()
    lane = torch.arange(W, device=dev)[None, :]
    ch = torch.arange(C, device=dev)[None, :, None]
    x_base = (x_row[:, None, None] * C + ch) * L  # [B, C, 1]
    y_base = (y_row[:, None] * C + ch[:, :, 0]) * L  # [B, C]

    mat = torch.full((B, W), neg, dtype=bank.dtype, device=dev)
    ins = mat.clone()
    dele = mat.clone()
    out = mat.clone()
    R = int(n_rows.max()) if B else 0
    # longest run of consecutive envelope lanes: the lane index minus the
    # index of the last lane outside the envelope before it
    idx = torch.arange(W, device=dev)[None, :].expand(B, W)
    last_out = torch.where(member, -1, idx).cummax(dim=1).values
    reach = int((idx - last_out).max()) if B * W else 0
    for j in range(1, R + 1):
        jf = j_off[:, None] + j  # true row per pair [B, 1]
        t = d + (jf - 1)  # i - 1 per lane
        valid = member & (t >= 0) & (t < x_len) & (jf <= y_len)
        xv = flat[x_base + t.clamp(0, L - 1)[:, None, :]]  # [B, C, W]
        yv = flat[y_base + (jf - 1).clamp(0, L - 1)][:, :, None]  # [B, C, 1]

        # emission: lse over the 4 marginalised ref symbols
        acc = xv[:, 0] + yv[:, 0]
        for r in range(1, 4):
            acc = _lse2(acc, xv[:, r] + yv[:, r])
        emit = acc - xv[:, CH_INS] - yv[:, CH_INS]

        if use_ik:
            # per-cell transitions: m2m(i-1, j-1) = stay_x(i-1) +
            # stay_y(j-1), m2i(i, j-1) = open_x(i), m2d(i-1, j) =
            # stay_x(i-1) + open_y(j); out-of-range gap values are 0
            tm1 = t - 1
            stay_xm1 = torch.where(
                (tm1 >= 0) & (tm1 < x_len),
                flat[x_base[:, CH_STAY] + tm1.clamp(0, L - 1)], 0.0)
            m2m = stay_xm1 + yv[:, CH_STAY]
            m2i = xv[:, CH_OPEN]
            m2d = stay_xm1 + yv[:, CH_OPEN]

        mat_c = torch.maximum(torch.maximum(mat + m2m, dele + d2m), ins + i2m)
        start_ok = (jf == 1) | (t == 0)
        mat_c = torch.maximum(mat_c, torch.where(start_ok, 0.0, neg))
        mat_c = torch.where(valid, mat_c + emit, neg)

        ins_c = torch.maximum(
            _lse2(_shift_left(ins, neg) + i2i, _shift_left(dele, neg) + d2i),
            _shift_left(mat, neg) + m2i,
        )
        ins_c = torch.where(valid, ins_c, neg)

        # the delete chain x[w] = max(lse(x[w-1] + c, k), b): a doubling
        # scan of (c, k, b) triples; halo lanes carry c = -inf, so no path
        # crosses a strip seam
        # (b and k ride in one [2, B, W] tensor: the row loop is
        # launch-bound on a card)
        c_vec = torch.where(valid, d2d, neg)
        bk = torch.where(valid, torch.stack([
            _shift_right(mat_c, 1, neg) + m2d,
            _shift_right(ins_c, 1, neg) + d2i,
        ]), neg)
        s = 1
        while s < reach:
            c_s = _shift_right(c_vec, s, 0.0)
            bk_s = torch.nn.functional.pad(bk[:, :, :-s], (s, 0), value=neg)
            # (c_s, k_s, b_s) applied first, then (c, k, b):
            # b = max(lse(b_s + c, k), b), k = lse(k_s + c, k)
            nxt = _lse2(bk_s + c_vec, bk[1])
            nxt[0] = torch.maximum(nxt[0], bk[0])
            bk = nxt
            c_vec = c_s + c_vec
            s *= 2
        del_c = torch.where(valid, torch.maximum(bk[1], bk[0]), neg)

        end_ok = valid & ((jf == y_len) | (t == x_len - 1))
        out = torch.maximum(out, torch.where(end_ok, mat_c, neg))
        mat, ins, dele = mat_c, ins_c, del_c

    lo = seg_start.long()[:, :, None]
    in_seg = (lane[:, None, :] >= lo) & (lane[:, None, :] < lo + seg_width.long()[:, :, None])
    segmax = torch.where(in_seg, out[:, None, :], neg).amax(dim=2)
    segmax = torch.where(segmax <= neg / 2, float("-inf"), segmax)
    end = out.amax(dim=1) if W else torch.full((B,), neg, device=dev)
    end = torch.where(end <= neg / 2, float("-inf"), end)
    score = end + ins_xy[:, 0] + ins_xy[:, 1]
    return torch.cat([score, segmax.reshape(-1)])


def ov_route(W: int) -> tuple:
    """K4's route for a band of W lanes, a function of W alone: ("warp",
    lpt) with the smallest lpt of WARP_LPTS whose warp covers the band
    (32 * lpt >= W), up to OV_WARP_MAX_LANES; past it ("cluster", (nct,
    warps, lpt)) of OV_CLUSTER_TABLE, up to OV_LANE_CAP.  No route takes a
    wider band (ValueError): the pipeline re-bands those."""
    for lpt in WARP_LPTS:
        if W <= 32 * lpt <= OV_WARP_MAX_LANES:
            return "warp", lpt
    if W > OV_LANE_CAP:
        raise ValueError(f"ov_route: a band of {W} lanes is past "
                         f"OV_LANE_CAP ({OV_LANE_CAP})")
    return "cluster", cluster_tiling(W, OV_CLUSTER_TABLE)


def _ov_route_ok(W: int, route) -> bool:
    kind, arg = route
    if kind == "warp":
        return arg in WARP_LPTS and W <= 32 * arg
    return kind == "cluster" and cluster_route_ok(
        W, arg, OV_CLUSTER_LPTS, ov_cluster_max_warps)


def launch_args(bank, meta, doff, seg_start, seg_width, ins_xy,
                trans) -> tuple:
    """The arguments every K4 entry of csrc/ov_fill.cu takes first (its
    route's own and the output follow)."""
    B, W = doff.shape
    _, C, L = bank.shape
    return (bank.data_ptr(), C, L, meta.data_ptr(), doff.data_ptr(), W,
            seg_start.data_ptr(), seg_width.data_ptr(), seg_start.shape[1],
            ins_xy.data_ptr(), trans.data_ptr(), B)


def ov_fill(bank, meta, doff, seg_start, seg_width, ins_xy, trans,
            route=None) -> torch.Tensor:
    """K4 on the tensors' device: csrc/ov_fill.cu for CUDA tensors, on the
    route ov_route picks from the band's width (each launch adds one to
    `ov_fill.launches` and to `warp_launches` or `cluster_launches`), the
    plain version for CPU tensors.  Same inputs and [B + B*S] float32
    output for all.  A failed launch, or a cluster shape the card refuses,
    raises on every route; none gives way to another.

    route, ("warp", lpt) or ("cluster", (nct, warps, lpt)), launches that
    route instead, for holding the routes against each other on the same
    inputs; it must cover the band."""
    B, W = doff.shape
    if route is None:
        route = ov_route(W)
    if not _ov_route_ok(W, route):
        raise ValueError(f"ov_fill: no route {route} for a band of {W} lanes")
    kind, arg = route
    dev = doff.device
    if dev.type == "cpu":
        with one_thread_on_cpu(dev):
            return ov_fill_reference(bank, meta, doff, seg_start, seg_width,
                                     ins_xy, trans)
    if dev.type != "cuda":
        raise RuntimeError(f"ov_fill: no kernel for device {dev}")
    from .. import kernels

    S = seg_start.shape[1]
    _, C, L = bank.shape
    check_tensors("ov_fill", {
        "bank": (bank, torch.float32, None),
        "meta": (meta, torch.int32, (B, 8)),
        "doff": (doff, torch.int32, (B, W)),
        "seg_start": (seg_start, torch.int32, (B, S)),
        "seg_width": (seg_width, torch.int32, (B, S)),
        "ins_xy": (ins_xy, torch.float32, (B, 2)),
        "trans": (trans, torch.float32, (9,)),
    }, dev)
    if C not in (5, 7):
        raise ValueError(f"ov_fill: the bank has {C} channels, not 5 or 7")
    out = torch.empty(B + B * S, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    with torch.cuda.device(dev):
        lib = kernels.library()
        args = launch_args(bank, meta, doff, seg_start, seg_width, ins_xy,
                           trans)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "warp":
            err = lib.quaff_ov_fill_warp(*args, arg, out.data_ptr(), stream)
        else:
            nct, warps, lpt = arg
            err = lib.quaff_ov_fill_cluster(*args, lpt, nct, warps,
                                            out.data_ptr(), stream)
    kernels.check_launch(err, "ov_fill", route, f"B={B}, W={W}, L={L}")
    ov_fill.launches += 1
    setattr(ov_fill, f"{kind}_launches", getattr(ov_fill, f"{kind}_launches") + 1)
    return out


ov_fill.launches = 0
ov_fill.warp_launches = 0
ov_fill.cluster_launches = 0


def overlap_scores(tables, batch: dict) -> torch.Tensor:
    """K4 on a chunk of tensors on one device (`prepare`'s input,
    overlap_scores_kernel): the unfetched [B + B*S] float32 tensor of pair
    scores (end + x/y insert sums, the float64 fill's "score"; -inf where
    no path ends) and per-strip raw end maxima, row-major [B, S] in
    pack_strips order (insert sums not added: they rank strips within a
    pair).  Unfetched, so a caller can enqueue more chunks before it
    waits."""
    inp = prepare(ov_tables(tables, batch["member"].device), batch)
    return ov_fill(**inp)
