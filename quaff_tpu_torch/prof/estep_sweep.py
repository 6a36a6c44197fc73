"""K2's and K3's cluster or smem tilings timed against each other on the
card: the measurement dp/estep.ESTEP_CLUSTER_TABLE's rows past
ESTEP_WIDE_LANES, ESTEP_SMEM_TABLE's rows and the global tier's warps
(ESTEP_GLOBAL_WARPS) are set from.

At each band width, chip_smoke.py phase 2b's wide recipe (--pairs reads,
8 by default, of 400 bases drawn from a random ref, each in a full
envelope, so every pair's band spans W lanes; local), and every tiling
of the route estep_route picks there that estep_route_ok takes: on the
cluster route for each lanes a thread, the fewest CTAs that hold the
tiles at each count of warps a CTA; on the smem route, and beside K3's
two-level cluster route, both smem tiers (the shared tier where a CTA's
run fits, the global tier always) at 4, 8 and 16 warps a CTA over 8 and
16 CTAs' worth of lanes a thread.  Each
tiling's K2 and K3 are timed by CUDA events (median of 3 runs on
distinct inputs, after a warm run) and checked against the table's
tiling on the same inputs (max abs difference of the forward scores and
of K3's tables: the tilings differ only in the order of sums).

    python -m quaff_tpu_torch.prof.estep_sweep 6000 8192 12070 16384
    python -m quaff_tpu_torch.prof.estep_sweep 98304 131072 --pairs 2

One line per width and kernel: the table's tiling, then each tiling's
"kind nct x warps x lpt: ms (max abs difference)", fastest first; the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import statistics


def wide_batch(W: int, seed: int = 8, n: int = 8, ylen: int = 400):
    """Phase 2b's wide recipe at W lanes: n reads of ylen bases copied from
    one random ref of W - ylen - 1 bases, with random qualities, each in
    a full envelope (PairBatch.build adds a halo lane)."""
    import numpy as np

    from ..dp.engine import PairBatch
    from ..dp.scores import ScoreTables
    from ..envelope import full_envelope
    from ..io.fastseq import FastSeq
    from ..model.params import default_params

    tables = ScoreTables.from_params(default_params())
    rng = np.random.default_rng(seed)
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, W - ylen - 1))
    pairs = []
    for b in range(n):
        s0 = int(rng.integers(0, len(xs) - ylen))
        y = FastSeq(name=f"w{b}", seq=xs[s0:s0 + ylen],
                    qual="".join(chr(33 + int(q))
                                 for q in rng.integers(3, 40, ylen)))
        pairs.append((FastSeq(name="xw", seq=xs), y,
                      full_envelope(len(xs), ylen)))
    return PairBatch.build(pairs, tables), tables


def tilings(W: int, kernel: str) -> list:
    """The routes (kind, (nct, warps, lpt)) timed for `kernel` at W lanes
    that estep_route_ok takes: on the cluster route (and the smem route's
    shared tier up to 65536 lanes) every lanes a thread, its tiles over the
    fewest CTAs at each count of warps a CTA; past 65536 lanes, and beside
    K3's two-level cluster route (its float32 fold against the smem
    route's float64 cells), both smem tiers at 4, 8 and 16 warps a CTA and
    the lanes a thread with which 8 or 16 CTAs cover the band, its tiles
    over the fewest CTAs."""
    from ..dp import estep
    from ..dp.fill_v2 import cluster_tiling

    kind, table = estep.estep_route(W, kernel)
    out = []
    if kind == "cluster" or W <= 65536:
        lpts = (estep.ESTEP_CLUSTER_LPTS if kind == "cluster"
                else range(1, estep.SMEM_MAX_LPT + 1))
        for lpt in lpts:
            tiles = -(-W // (32 * lpt))
            seen = set()
            for nct in range(1, estep.MAX_CLUSTER_CTAS2 + 1):
                t = (nct, -(-tiles // nct), lpt)
                if t[1] not in seen and estep.estep_route_ok(
                        W, (kind, t), kernel):
                    seen.add(t[1])
                    out.append((kind, t))
        if kind != "cluster" or estep.cluster_mode(W, table) != estep.TWO_FOLD:
            return out
    for warps in (4, 8, 16):
        for nct in (8, 16):
            lpt = -(-W // (32 * warps * nct))
            t = cluster_tiling(W, ((W, lpt, warps),))
            for k in ("smem", "global"):
                if (k, t) not in out and estep.estep_route_ok(W, (k, t),
                                                              kernel):
                    out.append((k, t))
    return out


def _ms(fn, args):
    import torch

    fn(args[0])  # warm
    times = []
    for a in args[1:]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(a)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def sweep(W: int, pairs: int = 8) -> dict:
    """{kernel: {route: (ms, max abs difference from the table's
    route)}} at W lanes on `pairs` pairs."""
    import torch

    from ..dp import estep, fill_v2
    from ..dp.engine import to_device

    pb, tables = wide_batch(W, n=pairs)
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(tables, "cuda")
    keys = [inp["keys"]] + [inp["keys"].clone() for _ in range(3)]
    fwd, rows, offs = estep.fwd_store(**inp, tables=v2)
    fin = fwd > fill_v2.NEG_INF / 2
    wrow = torch.stack([fin.float(), torch.where(fin, fwd, 0.0)])
    ws = [(wrow * torch.tensor([[1.0 + 1e-3 * i], [1.0]], device="cuda")
           ).contiguous() for i in range(4)]
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)
    part = estep.bwd_counts(*base, ws[0], rows, offs)[0]
    out = {"fwd_store": {}, "bwd_counts": {}}
    for r in tilings(W, "fwd_store"):
        err = float((estep.fwd_store(**inp, tables=v2, route=r)[0]
                     - fwd).abs().max())
        out["fwd_store"][r] = (_ms(lambda k: estep.fwd_store(
            **dict(inp, keys=k), tables=v2, route=r), keys), err)
    for r in tilings(W, "bwd_counts"):
        err = float((estep.bwd_counts(*base, ws[0], rows, offs, route=r)[0]
                     - part).abs().max())
        out["bwd_counts"][r] = (_ms(lambda w: estep.bwd_counts(
            *base, w, rows, offs, route=r), ws), err)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="+")
    ap.add_argument("--pairs", type=int, default=8)
    args = ap.parse_args(argv)
    from .. import kernels
    from ..dp import estep
    from .chains import card_label

    kernels.library()
    card = card_label()
    print(card, flush=True)
    for W in args.widths:
        res = sweep(W, args.pairs)
        for k, times in res.items():
            rows = sorted(times.items(), key=lambda kv: kv[1][0])
            print(f"W={W} B={args.pairs} {k} (table "
                  f"{estep.estep_route(W, k)}): "
                  + "; ".join("{} {} x {} x {}: {:.3f} ({:.3g})".format(
                      kind, *t, ms, err) for (kind, t), (ms, err) in rows)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
