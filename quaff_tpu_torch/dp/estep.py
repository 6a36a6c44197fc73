"""K2 and K3, the training E-step: the CUDA kernels, their plain-PyTorch
versions, and the glue that turns forward scores into read-level
responsibilities.

Ported from quaff_tpu/dp/pallas_counts.py:

  fwd_store / fwd_store_reference      K2 (_fwd_store): K1's Forward fill,
                                       kept scaled, that also stores every
                                       row's M/I/D cells, rows [3, B, Ly, W]
                                       relative to the row's float64 offset
                                       offsets [B, Ly]
  bwd_counts / bwd_counts_reference    K3 (_bwd_counts): the reverse sweep
                                       with posterior-weighted counts,
                                       per-pair tables [B, E] and d_sc [5, B]
  estep_reduce / estep_reduce_reference  the fixed-order sum of K3's
                                       per-pair tables over pairs (the
                                       two agree bit for bit)
  estep_fused_multi, estep_fused,      the entries (_estep_fused_core's
  estep_kernel                         glue in plain torch: it is not a
                                       Pallas kernel)

Each wrapper runs its CUDA kernel (csrc/estep.cu) on CUDA tensors, adding
one to its `launches` count, and its plain version on CPU tensors; any
other device raises.  K2 and K3 have two routes each, picked by
estep_route from the band's width: the warp route (csrc/estep_warp.cuh,
one warp per pair) up to the kernel's measured cutover, the block route
(K1's block fill with STORE in csrc/band_fill.cuh, bwd_counts_kernel in
estep.cu) past it; `warp_launches` and `block_launches` count each.  Both
routes keep one layout, so either route's K2 store feeds either route's
K3.  All take fill_v2.kernel_inputs's layout.  Count tables are flat:
E = 4*Km*Q match counts (symbol-major, then k-mer, then quality) + 4*Q
insert counts (token, quality) + 4*Ki transition counts (m2m, m2i, m2d,
m2e per indel context).

The TPU's rolled token window, its `sold`/K_OLDTOK* channels and
_prepare_bwd_extras, the one-hot MXU lookups and the padding of B and W
do not carry over: the card reads each lane's ref token and each row's
table entries directly.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import _shift_left, _shift_right, doubling_scan
from .fill_v2 import (
    D_SENTINEL,
    NEG_INF,
    WARP_LPTS,
    V2Tables,
    _lse2,
    band_fill_reference,
    check_tensors,
    kernel_inputs,
    table_specs,
)

# Widest band each kernel's warp route takes (csrc/estep_warp.cuh, one warp
# a pair, 32 * lpt lanes for lpt in WARP_LPTS); wider bands take the block
# route.  A function of the width alone, never of the card, so that the
# route, and with it the float32 sums, follow from the input.  Measured by
# chip_smoke.py phase 2b on its 257-512-lane batch (B=32, W=423), both
# routes forced on the same inputs (NVIDIA H100 80GB HBM3, 700 W; PERF.md):
# K2 at 16 lanes a thread 1.955 ms against its block route's 2.597, so
# 512; K3 at 16 lanes a thread 3.239 against 4.003, but its 16-lane build
# spills (~40/60 bytes, 11 local accesses in the row loop), so 256.  A
# chunk of 257-512 lanes runs K2's warp route and K3's block route on one
# stored-row layout.
ESTEP_WARP_MAX_LANES = {"fwd_store": 512, "bwd_counts": 256}


def table_size(tables: V2Tables) -> int:
    """E, the length of one flat count table for these tables."""
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    return 4 * Km * Q + 4 * Q + 4 * tables.n_ik


def warp_lpt(W: int):
    """The warp routes' lanes a thread for a band of W lanes: the smallest
    lpt of WARP_LPTS whose warp covers the band (32 * lpt >= W); None for a
    band wider than any warp."""
    return next((lpt for lpt in WARP_LPTS if W <= 32 * lpt), None)


def estep_route(W: int, kernel: str) -> tuple:
    """The route of K2 (kernel "fwd_store") or K3 ("bwd_counts") for a band
    of W lanes: ("warp", warp_lpt(W)) up to ESTEP_WARP_MAX_LANES[kernel]
    lanes, else ("block", 0): one block per pair."""
    lpt = warp_lpt(W)
    if lpt is not None and 32 * lpt <= ESTEP_WARP_MAX_LANES[kernel]:
        return "warp", lpt
    return "block", 0


def _check_route(name, route, W):
    """The route a wrapper takes: estep_route's, or one forced by the
    caller (the card tests and chip_smoke.py hold the two against each
    other), which must cover the band."""
    if route is None:
        return estep_route(W, name)
    kind, lpt = route
    if not (kind == "block" and lpt == 0
            or kind == "warp" and lpt in WARP_LPTS and W <= 32 * lpt):
        raise ValueError(f"{name}: no route {route} for a band of {W} lanes")
    return route


def _count(fn, kind):
    fn.launches += 1
    if kind == "warp":
        fn.warp_launches += 1
    else:
        fn.block_launches += 1


def _raise_on(err, name, kernels, B, W, Ly, kind=None):
    if err != 0:
        on = "" if kind is None else f" ({kind} route)"
        raise RuntimeError(f"{name} kernel launch failed{on}: "
                           f"{kernels.error_string(err)} (B={B}, W={W}, Ly={Ly})")


# ---------------------------------------------------------------------------
# K2


def fwd_store_reference(x_tok, keys, meta, doff, seg_start, seg_width,
                        tables: V2Tables, local: bool = True, max_prop=None):
    """The plain version of K2: (raw forward scores [B] float32, NEG_INF
    where no path ends; rows [3, B, Ly, W] float32, each row relative to
    its offset; offsets [B, Ly] float64).  The fill is kept scaled
    (fill_v2.band_fill_reference), so the scores do not drift."""
    B, W = doff.shape
    Ly = keys.shape[1]
    rows = torch.full((3, B, Ly, W), NEG_INF, dtype=torch.float32,
                      device=doff.device)
    offsets = torch.zeros((B, Ly), dtype=torch.float64, device=doff.device)
    out = band_fill_reference(x_tok, keys, meta, doff, seg_start, seg_width,
                              tables, mode="forward", local=local,
                              max_prop=max_prop, rows=rows, offsets=offsets)
    return out[:B], rows, offsets


def fwd_store(x_tok, keys, meta, doff, seg_start, seg_width,
              tables: V2Tables, local: bool = True, max_prop=None,
              route=None):
    """K2 on the tensors' device; same outputs as fwd_store_reference,
    except that rows and offsets past a pair's read length are left
    unwritten on the card (K3 never reads them).  On the card it takes
    estep_route's route, or `route` (("warp", lpt) or ("block", 0)) where
    given; a CPU tensor takes the plain version whatever the route."""
    dev = doff.device
    kind, lpt = _check_route("fwd_store", route, doff.shape[1])
    if dev.type == "cpu":
        return fwd_store_reference(x_tok, keys, meta, doff, seg_start,
                                   seg_width, tables, local, max_prop)
    if dev.type != "cuda":
        raise RuntimeError(f"fwd_store: no kernel for device {dev}")
    from .. import kernels

    B, W = doff.shape
    S = seg_start.shape[1]
    Ly, Lx = keys.shape[1], x_tok.shape[1]
    check_tensors("fwd_store", {
        "x_tok": (x_tok, torch.int8, (B, Lx)),
        "keys": (keys, torch.int32, (B, Ly, 4)),
        "meta": (meta, torch.int32, (B, 4)),
        "doff": (doff, torch.int32, (B, W)),
        "seg_start": (seg_start, torch.int32, (B, S)),
        "seg_width": (seg_width, torch.int32, (B, S)),
        **table_specs(tables),
    }, dev)
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    out = torch.empty(B + B * S, dtype=torch.float32, device=dev)
    rows = torch.empty((3, B, Ly, W), dtype=torch.float32, device=dev)
    offsets = torch.empty((B, Ly), dtype=torch.float64, device=dev)
    if B == 0:
        return out[:B], rows, offsets
    tabs = (tables.match.data_ptr(), tables.match_noq.data_ptr(),
            tables.insert.data_ptr(), tables.insert_noq.data_ptr(), Km, Q,
            tables.ik.data_ptr(), tables.n_ik, tables.trans.data_ptr())
    with torch.cuda.device(dev):
        lib = kernels.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "warp":
            err = lib.quaff_fwd_store_warp(
                x_tok.data_ptr(), Lx, keys.data_ptr(), Ly, meta.data_ptr(),
                doff.data_ptr(), W, *tabs, B, int(bool(local)), lpt,
                out.data_ptr(), rows.data_ptr(), offsets.data_ptr(), stream)
        else:
            scratch = None
            if W > kernels.max_smem_lanes(dev.index or 0):
                scratch = torch.empty(B * 6 * W, dtype=torch.float32,
                                      device=dev)
            err = lib.quaff_fwd_store(
                x_tok.data_ptr(), Lx, keys.data_ptr(), Ly, meta.data_ptr(),
                doff.data_ptr(), W, seg_start.data_ptr(),
                seg_width.data_ptr(), S, *tabs, B, int(bool(local)),
                0 if scratch is None else scratch.data_ptr(),
                out.data_ptr(), rows.data_ptr(), offsets.data_ptr(), stream)
    _raise_on(err, "fwd_store", kernels, B, W, Ly, kind)
    _count(fwd_store, kind)
    return out[:B], rows, offsets


fwd_store.launches = 0
fwd_store.warp_launches = 0
fwd_store.block_launches = 0


# ---------------------------------------------------------------------------
# K3


def bwd_counts_reference(x_tok, keys, meta, doff, tables: V2Tables, wrow,
                         rows, offsets, local: bool = True, max_prop=None):
    """The plain version of K3: a row loop from the last row to the first
    over [B, W] tensors, mirroring _bwd_kernel, with the row contributions
    added to per-pair tables by index_add_.

    wrow [2, B]: each pair's weight (its read-level responsibility) and
    its forward score as the posterior normaliser (0 where not finite).
    rows, offsets: K2's store.  The backward sweep is kept scaled as K2's
    forward fill is: after each row its largest backward match or insert
    cell is subtracted and added to the pair's float64 backward offset.  A
    posterior weight exp(fwd_src + trans + back_dst - fwd_total) takes the
    relative forward and backward cells plus the float32 row constant
    (forward offset + backward offset - fwd_total), formed in float64.
    Returns (partial [B, E], d_sc [5, B]: i2i, i2m, d2d, d2m and the
    back-start posterior per pair)."""
    neg = NEG_INF
    B, W = doff.shape
    Ly = keys.shape[1]
    dev = doff.device
    f32 = torch.float32
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    E = table_size(tables)
    o_ins, o_ik = 4 * Km * Q, 4 * Km * Q + 4 * Q
    xt = x_tok.long()
    Lx = xt.shape[1]
    x_len = meta[:, 0:1].long()
    y_len = meta[:, 1:2].long()
    has_q = meta[:, 2].bool()
    doffl = doff.long()
    not_sent = doff != D_SENTINEL
    d2d, d2m, i2i, i2m = tables.trans.unbind(0)
    w_pair = wrow[0]
    fnorm = wrow[1].double()
    reach = W if max_prop is None else min(int(max_prop), W)
    base_b = torch.arange(B, device=dev) * E

    def post(x, c):
        return torch.exp(torch.clamp(x + c, max=40.0))

    def row_const(j):
        """(forward offset of row j + backward offset - fwd_total) as
        float32 [B, 1]; row 0 has forward offset 0."""
        off = offsets[:, j - 1] if j >= 1 else torch.zeros_like(fnorm)
        return (off + off_b - fnorm).float()[:, None]

    partial = torch.zeros(B * E, dtype=f32, device=dev)
    d_sc = torch.zeros((5, B), dtype=f32, device=dev)
    bm_n = torch.full((B, W), neg, dtype=f32, device=dev)
    bi_n = bm_n.clone()
    me_n = torch.zeros((B, W), dtype=f32, device=dev)
    ie_n = torch.zeros((B, 1), dtype=f32, device=dev)
    off_b = torch.zeros(B, dtype=torch.float64, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    for j in range(Ly, 0, -1):
        mk, q, yt, ik_cur = keys[:, j - 1].long().unbind(1)
        ik_prev = (keys[:, j - 2, 3].long() if j >= 2
                   else torch.zeros(B, dtype=torch.long, device=dev))
        m2m_c, m2i_c, m2d_c, m2e_c = (c[:, None] for c in
                                      tables.ik[ik_cur].unbind(1))
        m2m_p, m2i_p = (c[:, None] for c in tables.ik[ik_prev, :2].unbind(1))
        emit4 = torch.where(has_q[:, None], tables.match[:, mk, q].T,
                            tables.match_noq[:, mk].T)
        ie_c = torch.where(has_q, tables.insert[yt, q],
                           tables.insert_noq[yt])[:, None]
        idx = doffl + (j - 1)
        valid = not_sent & (idx >= 0) & (idx < x_len) & (j <= y_len)
        tok = torch.gather(xt, 1, idx.clamp(0, Lx - 1))
        me_c = torch.where(valid, torch.gather(emit4, 1, tok), zero)

        # reverse delete chain: x[w] = lse(x[w+1] + d2d, d2m + from_match)
        from_match = me_n + bm_n
        c_vec = torch.where(valid, d2d, neg)
        b_vec = torch.where(valid, d2m + from_match, neg)
        x = doubling_scan(_lse2, c_vec.flip(1), b_vec.flip(1), reach, neg)
        bd = torch.where(valid, x.flip(1), neg)

        end_ok = valid & (j == y_len)
        if not local:
            end_ok &= idx == x_len - 1
        bi_lo = _shift_right(bi_n, 1, neg)
        bm_c = _lse2(
            _lse2(torch.where(end_ok, m2e_c, neg), m2m_c + from_match),
            _lse2(m2i_c + ie_n + bi_lo, m2d_c + _shift_left(bd, neg)),
        )
        bm_c = torch.where(valid, bm_c, neg)
        bi_c = torch.where(valid, _lse2(i2m + from_match, i2i + ie_n + bi_lo),
                           neg)

        # posterior transition weights (rows past a pair's read length
        # may hold anything: every term is masked by `valid`)
        fm_c, fi_c, fd_c = rows[0, :, j - 1], rows[1, :, j - 1], rows[2, :, j - 1]
        if j >= 2:
            fm_p, fi_p, fd_p = (rows[0, :, j - 2], rows[1, :, j - 2],
                                rows[2, :, j - 2])
        else:
            fm_p = fi_p = fd_p = torch.full((B, W), neg, dtype=f32, device=dev)
        base = me_c + bm_c
        cc, cp, c0 = row_const(j), row_const(j - 1), row_const(0)

        def mask(v):
            return torch.where(valid, v, zero)

        w_m2m = mask(post(fm_p + m2m_p + base, cp))
        w_d2m = mask(post(fd_p + d2m + base, cp))
        w_i2m = mask(post(fi_p + i2m + base, cp))
        p_s2m = post(base, c0)
        start_ok = valid if local else valid & (idx == 0)
        if j != 1:
            start_ok = torch.zeros_like(valid)
        w_s2m = torch.where(start_ok, p_s2m, zero)
        mc = w_m2m + w_d2m + w_i2m + w_s2m
        w_m2i = mask(post(_shift_left(fm_p, neg) + m2i_p + ie_c + bi_c, cp))
        w_i2i = mask(post(_shift_left(fi_p, neg) + i2i + ie_c + bi_c, cp))
        w_m2d = mask(post(_shift_right(fm_c, 1, neg) + m2d_c + bd, cc))
        w_d2d = mask(post(_shift_right(fd_c, 1, neg) + d2d + bd, cc))
        w_m2e = torch.where(end_ok, post(fm_c + m2e_c, cc), zero)

        row_sum = (mc + w_m2i + w_i2i).sum(1)
        factor = torch.where(row_sum > 1e-30, w_pair / row_sum, zero)
        for a in range(4):
            partial.index_add_(
                0, base_b + a * Km * Q + mk * Q + q,
                torch.where(tok == a, mc, zero).sum(1) * factor)
        partial.index_add_(0, base_b + o_ins + yt * Q + q,
                           (w_m2i + w_i2i).sum(1) * factor)
        for c, (ctx, wt) in enumerate(((ik_prev, w_m2m), (ik_prev, w_m2i),
                                       (ik_cur, w_m2d), (ik_cur, w_m2e))):
            partial.index_add_(0, base_b + o_ik + ctx * 4 + c,
                               wt.sum(1) * factor)
        for k, wt in enumerate((w_i2i, w_i2m, w_d2d, w_d2m)):
            d_sc[k] += wt.sum(1) * factor
        d_sc[4] += w_s2m.sum(1)

        # scale the backward row carried to the next one
        top = torch.maximum(bm_c, bi_c).amax(1)
        shift = torch.where(top > neg / 2, top, 0.0)
        bm_c = torch.where(valid, bm_c - shift[:, None], neg)
        bi_c = torch.where(valid, bi_c - shift[:, None], neg)
        off_b = off_b + shift.double()
        bm_n, bi_n, me_n, ie_n = bm_c, bi_c, me_c, ie_c
    return partial.view(B, E), d_sc


def bwd_counts(x_tok, keys, meta, doff, tables: V2Tables, wrow, rows,
               offsets, local: bool = True, max_prop=None, route=None):
    """K3 on the tensors' device; same outputs as bwd_counts_reference.
    On the card the per-pair tables are built without float atomics, so
    repeated runs give bit-identical tables.  The route is chosen as
    fwd_store's."""
    dev = doff.device
    kind, lpt = _check_route("bwd_counts", route, doff.shape[1])
    if dev.type == "cpu":
        return bwd_counts_reference(x_tok, keys, meta, doff, tables, wrow,
                                    rows, offsets, local, max_prop)
    if dev.type != "cuda":
        raise RuntimeError(f"bwd_counts: no kernel for device {dev}")
    from .. import kernels

    B, W = doff.shape
    Ly, Lx = keys.shape[1], x_tok.shape[1]
    check_tensors("bwd_counts", {
        "x_tok": (x_tok, torch.int8, (B, Lx)),
        "keys": (keys, torch.int32, (B, Ly, 4)),
        "meta": (meta, torch.int32, (B, 4)),
        "doff": (doff, torch.int32, (B, W)),
        "wrow": (wrow, torch.float32, (2, B)),
        "rows": (rows, torch.float32, (3, B, Ly, W)),
        "offsets": (offsets, torch.float64, (B, Ly)),
        **table_specs(tables),
    }, dev)
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    E = table_size(tables)
    partial = torch.empty((B, E), dtype=torch.float32, device=dev)
    d_sc = torch.empty((5, B), dtype=torch.float32, device=dev)
    if B == 0:
        return partial, d_sc
    args = (x_tok.data_ptr(), Lx, keys.data_ptr(), Ly, meta.data_ptr(),
            doff.data_ptr(), W,
            tables.match.data_ptr(), tables.match_noq.data_ptr(),
            tables.insert.data_ptr(), tables.insert_noq.data_ptr(), Km, Q,
            tables.ik.data_ptr(), tables.n_ik, tables.trans.data_ptr(),
            wrow.data_ptr(), rows.data_ptr(), offsets.data_ptr(), B,
            int(bool(local)))
    with torch.cuda.device(dev):
        lib = kernels.library()
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "warp":
            err = lib.quaff_bwd_counts_warp(
                *args, lpt, partial.data_ptr(), d_sc.data_ptr(), stream)
        else:
            scratch = None
            if W > kernels.max_smem_lanes(dev.index or 0, "bwd_counts"):
                scratch = torch.empty(B * 8 * W, dtype=torch.float32,
                                      device=dev)
            err = lib.quaff_bwd_counts(
                *args, 0 if scratch is None else scratch.data_ptr(),
                partial.data_ptr(), d_sc.data_ptr(), stream)
    _raise_on(err, "bwd_counts", kernels, B, W, Ly, kind)
    _count(bwd_counts, kind)
    return partial, d_sc


bwd_counts.launches = 0
bwd_counts.warp_launches = 0
bwd_counts.block_launches = 0


# warps of the count reduction's column tile (csrc/estep.cu kRedWarps)
REDUCE_WARPS = 8


def estep_reduce_reference(partial):
    """The plain version of the count reduction, [B, E] float32 -> [E], in
    the kernel's order step by step (csrc/estep.cu): row group r adds rows
    r*G .. r*G+G-1 to a [G, E] accumulator (rows past B add nothing), then
    the G partial sums combine by the tree ((0+1)+(2+3))+((4+5)+(6+7)).
    Each step is a float32 add of the same operands as the card's, so the
    two agree bit for bit."""
    B, E = partial.shape
    acc = torch.zeros((REDUCE_WARPS, E), dtype=partial.dtype,
                      device=partial.device)
    for r in range(0, B, REDUCE_WARPS):
        rows = partial[r : r + REDUCE_WARPS]
        acc[: rows.shape[0]] += rows
    while acc.shape[0] > 1:
        acc = acc[0::2] + acc[1::2]
    return acc[0]


def estep_reduce(partial):
    """Sum K3's per-pair tables over pairs, in estep_reduce_reference's
    fixed order, on the card."""
    dev = partial.device
    if dev.type == "cpu":
        return estep_reduce_reference(partial)
    if dev.type != "cuda":
        raise RuntimeError(f"estep_reduce: no kernel for device {dev}")
    from .. import kernels

    if partial.dtype != torch.float32 or not partial.is_contiguous() \
            or partial.dim() != 2:
        raise ValueError("estep_reduce: partial must be a contiguous "
                         "[B, E] float32 tensor")
    B, E = partial.shape
    out = torch.empty(E, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = kernels.library().quaff_estep_reduce(
            partial.data_ptr(), B, E, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _raise_on(err, "estep_reduce", kernels, B, E, 0)
    estep_reduce.launches += 1
    return out


estep_reduce.launches = 0


# ---------------------------------------------------------------------------
# entries


def unpack_counts(flat: np.ndarray, tables: V2Tables) -> dict:
    """A flat [E] count table as the reference-shaped arrays."""
    Km, Q = tables.match.shape[1], tables.match.shape[2]
    o_ins, o_ik = 4 * Km * Q, 4 * Km * Q + 4 * Q
    ik4 = flat[o_ik:].reshape(tables.n_ik, 4)
    return {
        "match_counts": flat[:o_ins].reshape(4, Km, Q),
        "insert_counts": flat[o_ins:o_ik].reshape(4, Q),
        "m2m": ik4[:, 0],
        "m2i": ik4[:, 1],
        "m2d": ik4[:, 2],
        "m2e": ik4[:, 3],
    }


def _fwd(v2tab, inp, local, max_prop):
    raw, *store = fwd_store(**inp, tables=v2tab, local=local,
                            max_prop=max_prop)
    return torch.where(raw <= NEG_INF / 2, float("-inf"), raw), store


def _counts(v2tab, inp, weights, fnorm, store, local, max_prop, extra=()):
    """K3 + the reduction; fetches [extra..., table, d_sc] in one copy and
    returns (the extra tensors as float64 numpy, counts dict)."""
    B = inp["doff"].shape[0]
    partial, d_sc = bwd_counts(
        inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2tab,
        torch.stack([weights, fnorm]).contiguous(), *store, local, max_prop)
    flat = estep_reduce(partial)
    parts = [*extra, flat, d_sc.reshape(-1)]
    host = torch.cat(parts).cpu().numpy().astype(np.float64)
    out, o = [], 0
    for t in extra:
        out.append(host[o : o + t.numel()])
        o += t.numel()
    E = flat.numel()
    counts = unpack_counts(host[o : o + E], v2tab)
    sc = host[o + E :].reshape(5, B)
    counts.update(i2i=sc[0], i2m=sc[1], d2d=sc[2], d2m=sc[3],
                  back_start_post=sc[4])
    return out, counts


def estep_fused_multi(v2tab: V2Tables, batch: dict, gid, null_lls,
                      local: bool = True, max_prop=None):
    """The E-step of one batch whose pairs may come from several reads
    (pallas_counts.estep_fused_multi): K2, then each read group's
    y_ll[g] = lse(null_ll[g], forward scores of group g) and each pair's
    weight exp(fwd_b - y_ll[gid_b]) on the device in float32, then K3 and
    the reduction.  gid [B] maps pairs to read groups; null_lls [G] holds
    each group's null log-likelihood (-inf without a null model).
    Returns (fwd [B], y_ll [G], counts summed over the batch), float64
    numpy; a group's pairs must all be in this batch, since the weights
    normalise over them."""
    inp = kernel_inputs(batch)
    dev = inp["doff"].device
    fwd, store = _fwd(v2tab, inp, local, max_prop)
    gid_t = torch.as_tensor(np.asarray(gid), dtype=torch.long, device=dev)
    nl = torch.as_tensor(
        np.where(np.isfinite(null_lls), null_lls, -np.inf), dtype=torch.float32,
        device=dev)
    G = nl.shape[0]
    finite = torch.isfinite(fwd)
    oh = gid_t[:, None] == torch.arange(G, device=dev)[None, :]
    gmax = torch.where(oh, fwd[:, None], float("-inf")).amax(dim=0)
    m = torch.maximum(gmax, nl)
    gsum = torch.where(oh, torch.exp(fwd[:, None] - m[None, :]), 0.0).sum(0)
    y_ll_g = m + torch.log(gsum + torch.exp(nl - m))
    weights = torch.where(finite, torch.exp(fwd - y_ll_g[gid_t]), 0.0)
    fnorm = torch.where(finite, fwd, 0.0)
    (fwd_h, y_ll_h), counts = _counts(v2tab, inp, weights, fnorm, store,
                                      local, max_prop, extra=(fwd, y_ll_g))
    return fwd_h, y_ll_h, counts


def estep_fused(v2tab: V2Tables, batch: dict, null_ll: float,
                local: bool = True, max_prop=None):
    """Single-read E-step: (fwd [B], y_ll [1], counts)."""
    B = int(batch["member"].shape[0])
    return estep_fused_multi(v2tab, batch, np.zeros(B, np.int32),
                             np.asarray([null_ll], np.float64), local=local,
                             max_prop=max_prop)


def estep_kernel(v2tab: V2Tables, batch: dict, weights, f_norm,
                 local: bool = True, max_prop=None):
    """K2 + K3 with caller-given pair weights [B] and normalisers f_norm
    [B] (each pair's own forward score): (fwd [B], counts)."""
    inp = kernel_inputs(batch)
    dev = inp["doff"].device
    fwd, store = _fwd(v2tab, inp, local, max_prop)
    w = torch.as_tensor(np.asarray(weights), dtype=torch.float32, device=dev)
    fn = torch.as_tensor(np.asarray(f_norm), dtype=torch.float32, device=dev)
    fn = torch.where(torch.isfinite(fn), fn, 0.0)
    (fwd_h,), counts = _counts(v2tab, inp, w, fn, store, local, max_prop,
                               extra=(fwd,))
    return fwd_h, counts
