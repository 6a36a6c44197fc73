"""K2's and K3's cluster or smem tilings timed against each other on the
card: the measurement dp/estep.ESTEP_CLUSTER_TABLE's rows past
ESTEP_WIDE_LANES and ESTEP_SMEM_TABLE's rows are set from.

At each band width, chip_smoke.py phase 2b's wide recipe (8 reads of 400
bases drawn from a random ref, each in a full envelope, so every pair's
band spans W lanes; local), and every tiling of the route estep_route
picks there (cluster or smem) that estep_route_ok takes: for each lanes
a thread, the fewest CTAs that hold the tiles at each count of warps a
CTA.  Each tiling's K2 and K3 are timed by CUDA events
(median of 3 runs on distinct inputs, after a warm run) and checked
against the table's tiling on the same inputs (max abs difference of the
forward scores and of K3's tables: the tilings differ only in the order
of float32 sums).

    python -m quaff_tpu_torch.prof.estep_sweep 6000 8192 12070 16384

One line per width and kernel: the table's tiling, then each tiling's
"nct x warps x lpt: ms (max abs difference)", fastest first; the card's
name and power limit first.
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
    """Every (nct, warps, lpt) of the route kind estep_route picks for
    `kernel` at W lanes ("cluster" or "smem") that estep_route_ok takes,
    with its tiles over the fewest CTAs at that many warps a CTA."""
    from ..dp import estep

    kind = estep.estep_route(W, kernel)[0]
    lpts = (estep.ESTEP_CLUSTER_LPTS if kind == "cluster"
            else range(1, estep.SMEM_MAX_LPT + 1))
    out = []
    for lpt in lpts:
        tiles = -(-W // (32 * lpt))
        seen = set()
        for nct in range(1, estep.MAX_CLUSTER_CTAS2 + 1):
            t = (nct, -(-tiles // nct), lpt)
            if t[1] not in seen and estep.estep_route_ok(
                    W, (kind, t), kernel):
                seen.add(t[1])
                out.append(t)
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


def sweep(W: int) -> dict:
    """{kernel: {tiling: (ms, max abs difference from the table's
    tiling)}} at W lanes."""
    import torch

    from ..dp import estep, fill_v2
    from ..dp.engine import to_device

    pb, tables = wide_batch(W)
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
    kind = {k: estep.estep_route(W, k)[0] for k in out}
    for t in tilings(W, "fwd_store"):
        r = (kind["fwd_store"], t)
        err = float((estep.fwd_store(**inp, tables=v2, route=r)[0]
                     - fwd).abs().max())
        out["fwd_store"][t] = (_ms(lambda k: estep.fwd_store(
            **dict(inp, keys=k), tables=v2, route=r), keys), err)
    for t in tilings(W, "bwd_counts"):
        r = (kind["bwd_counts"], t)
        err = float((estep.bwd_counts(*base, ws[0], rows, offs, route=r)[0]
                     - part).abs().max())
        out["bwd_counts"][t] = (_ms(lambda w: estep.bwd_counts(
            *base, w, rows, offs, route=r), ws), err)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="+")
    args = ap.parse_args(argv)
    from .. import kernels
    from ..dp import estep
    from .chains import card_label

    kernels.library()
    card = card_label()
    print(card, flush=True)
    for W in args.widths:
        res = sweep(W)
        for k, times in res.items():
            rows = sorted(times.items(), key=lambda kv: kv[1][0])
            print(f"W={W} {k} (table {estep.estep_route(W, k)}): "
                  + "; ".join("{} x {} x {}: {:.3f} ({:.3g})".format(
                      *t, ms, err) for t, (ms, err) in rows)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
