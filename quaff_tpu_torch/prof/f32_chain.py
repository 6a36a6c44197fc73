"""Which float32 step of K2 and K3 loses the back-start posterior on wide
global bands: a CPU emulation of the kernels' arithmetic, run through the
plain versions.

The back-start posterior exp(backward total - forward score) is 1 in
exact arithmetic.  On global bands of reads that need thousands of
deletions (the card tests' recipe: reads of up to 1024 rows over refs of
W / 2 + 64 bases) the block routes' former arithmetic put it 6.8e-3
(8192 lanes) off 1 and the per-pair sums 2.2e-2 (16384) off the plain
versions', the plain versions within 1.5e-3 of 1 (on the card).  This probe runs
the plain versions (dp/estep.py) with two of their steps swapped for the
kernels' forms, in float32 on the CPU:

  - the delete chain: the plain version's doubling scan, or the block
    route's (csrc/band_fill.cuh, csrc/estep.cu): each thread of 1024
    composes its lanes' steps one after another, a warp scan and a scan
    of the warp totals give each thread its entering value, and the
    thread replays its lanes one after another ("seq"); or the WIDE form,
    each thread's lanes relative to its largest opening term and each
    lane's cell from its inclusive map ("wide");
  - K3's row shift: the row's largest backward cell ("max"), or its
    backward match cell at the row's posterior mode ("mode");
  - K2's cells in float64 with each log-add-exp's correction in float32,
    rows shifted by their largest match or insert cell ("f64": the wide
    arithmetic the kernels run past dp/estep.ESTEP_WIDE_LANES, through
    band_fill_reference(..., wide=True)), with K3's wide chain and mode
    shift.

and holds each backward total against the float64 forward fill (the
plain version run in float64).  The kernels' expf / log1pf and
PyTorch's round alike but not bit for bit, so the emulation shows the
size of each step's error, not the card's last digits:

    python -m quaff_tpu_torch.prof.f32_chain 8192 16384
    # the card tests' forced 8 x 2 x 16 tiling's gap-order-1 band
    python -m quaff_tpu_torch.prof.f32_chain 8192 --seed 8209 --pairs 3 \
        --params tests/data/params-gaporder1.json

One line per band and variant: the backward total's error against the
float64 forward score per pair (nats), and the forward fill's.
"""

from __future__ import annotations

import argparse
import inspect
import math
import sys

import numpy as np
import torch

from ..dp import estep, fill_v2
from ..dp.scores import ScoreTables
from ..model.params import default_params

NEG = fill_v2.NEG_INF
THREADS = 1024  # the former block routes' threads a pair


def global_band(W: int, seed: int, B: int = 4, params=None):
    """K2's and K3's inputs for B pairs of random reads of up to
    min(W // 4, 1024) rows over random refs of up to W // 2 + 64 bases,
    each in one strip over every diagonal that fits the band (the card
    tests' global recipe, random_fill_inputs drawn in the same order), and
    the tables of `params` (QuaffParams; None: the default ones)."""
    v2 = fill_v2.V2Tables.from_tables(
        ScoreTables.from_params(params or default_params()))
    Km, Q = v2.match.shape[1], v2.match.shape[2]
    Lx, Ly, S = W // 2 + 64, min(W // 4, 1024), 3
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, Km, (B, Ly)), rng.integers(0, Q, (B, Ly)),
                     rng.integers(0, 4, (B, Ly)),
                     rng.integers(0, v2.n_ik, (B, Ly))], axis=2)
    meta = np.zeros((B, 4), np.int64)
    doff = np.full((B, W), fill_v2.D_SENTINEL, np.int64)
    seg_start = np.zeros((B, S), np.int64)
    seg_width = np.zeros((B, S), np.int64)
    for b in range(B):
        ylen = int(rng.integers(max(1, min(Ly, W) // 2), min(Ly, W) + 1))
        xlen = int(rng.integers(1, min(Lx, W - ylen + 1) + 1))
        seg_width[b, 0] = xlen + ylen - 1
        doff[b, :xlen + ylen - 1] = np.arange(-(ylen - 1), xlen)
        meta[b, :3] = xlen, ylen, int(rng.random() < 0.5)

    def t(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt)

    inp = {"x_tok": t(rng.integers(0, 4, (B, Lx)), torch.int8),
           "keys": t(keys), "meta": t(meta), "doff": t(doff),
           "seg_start": t(seg_start), "seg_width": t(seg_width)}
    return inp, v2


def comb(a, b):
    """The block routes' log-add-exp (band_fill.cuh comb<false>)."""
    m = torch.maximum(a, b)
    return torch.where(m < -1e38, m, m + torch.log1p(torch.exp(-(a - b).abs())))


def _warp_scan(c, b):
    """Inclusive scan of steps x -> comb(x + c, b) over the last axis of 32
    lanes, in the order of band_fill.cuh's warp_scan."""
    lane = torch.arange(32)
    for off in (1, 2, 4, 8, 16):
        co, bo = torch.roll(c, off, -1), torch.roll(b, off, -1)
        m = lane >= off
        b, c = torch.where(m, comb(bo + c, b), b), torch.where(m, co + c, c)
    return c, b


def block_chain(c_vec, b_vec, wide: bool):
    """x[w] = comb(x[w-1] + c[w], b[w]) over the last axis (x[-1] = -inf)
    as the block routes compute it: THREADS threads of lpt lanes, each
    composing its lanes, a warp scan and a scan of the warp totals
    (block_scan_in), then the replay (wide: relative to the thread's
    largest opening term, each lane from its inclusive map)."""
    B, W = c_vec.shape
    lpt = -(-W // THREADS)
    pad = THREADS * lpt - W
    c = torch.cat([c_vec, torch.zeros(B, pad)], 1).view(B, THREADS, lpt)
    bb = torch.cat([b_vec, torch.full((B, pad), -math.inf)], 1).view(
        B, THREADS, lpt)
    r = torch.zeros(B, THREADS)
    if wide:
        r = torch.where(bb > NEG / 2, bb, -math.inf).amax(2)
        r = torch.where(r > NEG / 2, r, 0.0)
    pc, pb = torch.empty_like(c), torch.empty_like(c)
    c_acc, b_acc = torch.zeros(B, THREADS), torch.full((B, THREADS), -math.inf)
    for k in range(lpt):
        b_acc = comb(b_acc + c[:, :, k], bb[:, :, k] - r)
        c_acc = c_acc + c[:, :, k]
        pc[:, :, k], pb[:, :, k] = c_acc, b_acc
    b_acc = r + b_acc if wide else b_acc
    nw = THREADS // 32
    cw, bw = _warp_scan(c_acc.view(B, nw, 32), b_acc.view(B, nw, 32))
    c_ex, b_ex = torch.roll(cw, 1, -1), torch.roll(bw, 1, -1)
    c_ex[..., 0], b_ex[..., 0] = 0.0, -math.inf
    sc, sb = _warp_scan(
        torch.cat([cw[..., 31], torch.zeros(B, 32 - nw)], 1),
        torch.cat([bw[..., 31], torch.full((B, 32 - nw), -math.inf)], 1))
    ce, be = torch.roll(sc, 1, -1), torch.roll(sb, 1, -1)
    ce[:, 0], be[:, 0] = 0.0, -math.inf
    x = comb(be[:, :nw, None] + c_ex, b_ex).reshape(B, THREADS)
    if wide:
        out = r[:, :, None] + comb((x - r)[:, :, None] + pc, pb)
    else:
        out = torch.empty(B, THREADS, lpt)
        for k in range(lpt):
            x = comb(x + c[:, :, k], bb[:, :, k])
            out[:, :, k] = x
    return out.reshape(B, -1)[:, :W]


def _patched(fn, edits, **names):
    """The plain version `fn` with source edits (old, new) applied, each of
    which must be found, compiled with `names` in scope."""
    src = inspect.getsource(fn)
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"{fn.__name__} changed: {old.strip()!r} not found")
        src = src.replace(old, new)
    ns = dict(vars(sys.modules[fn.__module__]), **names)
    exec(src, ns)
    return ns[fn.__name__]


_K3_SCAN = "x = doubling_scan(_lse2, c_vec.flip(1), b_vec.flip(1), reach, neg)"
_K3_TOP = "        top = torch.maximum(bm_c, bi_c).amax(1)\n"
_K3_MODE = _K3_TOP + """        key = torch.where(valid & (fm_c > neg / 2), fm_c + bm_c,
                          -float("inf"))
        km, at = key.max(1)
        top = torch.where(km > neg / 2, bm_c.gather(1, at[:, None])[:, 0], top)
"""
_K2_SCAN = """        s = 1
        while s < reach:
            b_vec = combine(_shift_right(b_vec, s, neg) + c_vec, b_vec)
            c_vec = _shift_right(c_vec, s, 0.0) + c_vec
            s *= 2
"""


def k2(inp, v2, chain=None, wide=False):
    """K2's plain version (scores, rows, offsets) in float32 cells, its
    delete chain `chain` (None: the doubling scan); with wide, its float64
    cells (the doubling scan)."""
    B, W = inp["doff"].shape
    Ly = inp["keys"].shape[1]
    rows = torch.full((3, B, Ly, W), NEG)
    offs = torch.zeros((B, Ly), dtype=torch.float64)
    fill = fill_v2.band_fill_reference
    if chain is not None:
        fill = _patched(fill, [(_K2_SCAN, "        b_vec = CHAIN(c_vec, b_vec)\n")],
                        CHAIN=chain)
    out = fill(**inp, tables=v2, mode="forward", local=False, rows=rows,
               offsets=offs, **({"wide": True} if wide else {}))
    return out[:B], rows, offs


def k3_back_start(inp, v2, store, fnorm, chain=None, mode_shift=False):
    """K3's plain version's back-start posterior per pair on K2's store,
    normalised by the float64 `fnorm`, its delete chain `chain` (None:
    the doubling scan) and its row shift at the posterior mode."""
    edits = [("fnorm = wrow[1].double()", "fnorm = FNORM")]
    if chain is not None:
        edits.append((_K3_SCAN, "x = CHAIN(c_vec.flip(1), b_vec.flip(1))"))
    if mode_shift:
        edits.append((_K3_TOP, _K3_MODE))
    fn = _patched(estep.bwd_counts_reference, edits, CHAIN=chain, FNORM=fnorm)
    wrow = torch.stack([torch.ones_like(fnorm), fnorm]).float().contiguous()
    _, sc = fn(inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
               *store, local=False)
    return sc[4].double()


VARIANTS = {
    "plain": (None, False),       # float32 cells, the doubling scan
    "seq+max": ("seq", False),    # the block routes' former arithmetic
    "wide+max": ("wide", False),  # the WIDE chain alone
    "seq+mode": ("seq", True),    # the posterior-mode shift alone
    "wide+mode": ("wide", True),  # K3's wide arithmetic, K2 in float32
    "f64+mode": ("f64", True),    # the wide arithmetic: K2 in float64
}


def probe(W: int, variants=tuple(VARIANTS), seed=None, pairs=4,
          params=None) -> list:
    """Lines of the probe for one band width (seed W + 7 by default, the
    card tests' global bands')."""
    inp, v2 = global_band(W, W + 7 if seed is None else seed, pairs, params)
    B = inp["doff"].shape[0]
    exact = fill_v2.band_fill_reference(**inp, tables=v2, mode="forward",
                                        local=False, dtype=torch.float64)[:B]
    lines = [f"W={W}: pairs (xlen, ylen) "
             f"{[tuple(m[:2]) for m in inp['meta'].tolist()]}; float64 forward "
             f"scores {[round(float(x), 3) for x in exact]}"]
    stores = {}
    for name in variants:
        kind, mode = VARIANTS[name]
        chain = None if kind is None else (
            lambda c, b, wide=(kind != "seq"): block_chain(c, b, wide))
        if kind not in stores:
            stores[kind] = (k2(inp, v2, wide=True) if kind == "f64"
                            else k2(inp, v2, chain))
        fwd, rows, offs = stores[kind]
        bsp = k3_back_start(inp, v2, (rows, offs), exact, chain, mode)
        fin = torch.isfinite(exact)
        err_b = torch.where(fin, torch.log(bsp), 0.0)
        err_f = torch.where(fin, fwd.double() - exact, 0.0)
        lines.append(
            f"W={W} {name}: backward total - float64 forward "
            f"{['%+.2e' % v for v in err_b.tolist()]} (max "
            f"{float(err_b.abs().max()):.2e}); forward fill - float64 "
            f"{['%+.2e' % v for v in err_f.tolist()]}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("widths", nargs="*", type=int, default=[8192, 16384])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seed", type=int, default=None,
                    help="the band's seed (default: W + 7)")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--params", default=None,
                    help="a parameter JSON file (default: the default "
                    "parameters)")
    args = ap.parse_args(argv)
    params = None
    if args.params:
        from ..model.params import QuaffParams

        with open(args.params) as f:
            params = QuaffParams.from_json(f.read())
    for W in args.widths:
        for line in probe(W, tuple(args.variants.split(",")), args.seed,
                          args.pairs, params):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
