"""K1's smem-route tilings on both its tiers timed against each other on
the card, on long reads: with chip_smoke.py phase 4b's sweeps at its align
-kmatchoff chunk and its lambda-length chunk, the measurement
dp/fill_v2.FILL_SMEM_TABLE's rows and FILL_GLOBAL_WARPS are set from.

At each band width, --pairs reads (2) of --rows bases (8600) copied from
one random ref of W - rows - 1 bases (each base substituted with
probability 7.2%, followed by an inserted base 2.4%, deleted 2.4%; random
qualities), each in a full envelope, so every pair's band spans W lanes:
the long reads' wide bands of align -kmatchoff
(tests/test_torch_kernel_cuda.py's _long_read_band at real alignments),
local.  Each route of tier_routes (the shared tier at every tiling that
covers the band and fits a CTA, smem_tilings; the global tier at 16 CTAs
of 4, 8 and 16 warps and, where the band fits the shared tier, at the
table's tiling) is timed by CUDA events (median of 3 runs on distinct
inputs, after a warm run) and held against the plain version (one run) at
K1's tolerance, rtol 1e-5 / atol 1e-3.

    python -m quaff_tpu_torch.prof.fill_sweep 22882 131072
    python -m quaff_tpu_torch.prof.fill_sweep 30000 49500 --pairs 8 \
        --rows 3000 --modes viterbi   # chunks of phase 4b's shape

One line per width and mode: the table's route, then each route's "tier
nct x warps x lpt: ms (max abs error against the plain version)", fastest
first, "!" after one outside the tolerance; the card's name and power
limit first.
"""

from __future__ import annotations

import argparse
import statistics

RTOL, ATOL = 1e-5, 1e-3  # K1's parity tolerance


def smem_tilings(W: int, max_lpt: int = 27) -> list:
    """Every (nct, warps, lpt) of K1's smem route for a band of W lanes:
    for each lanes a thread up to max_lpt and at most 4, 8 and 16 warps a
    CTA, the fewest CTAs (up to fill_v2.MAX_CLUSTER_CTAS2) that hold its
    tiles, spread evenly, whose CTA fits the card's shared memory."""
    from ..dp import fill_v2

    out = []
    for lpt in range(1, max_lpt + 1):
        tiles = -(-W // (32 * lpt))
        for cap in (4, 8, 16):
            nct = -(-tiles // cap)
            t = (nct, -(-tiles // nct), lpt)
            if fill_v2._fill_route_ok(W, ("smem", t)) and t not in out:
                out.append(t)
    return out


def tier_routes(W: int) -> list:
    """[(route kind, tiling)] of both tiers of K1's smem route that
    fill_sweep times at W lanes: ("smem", t) for every t of
    smem_tilings(W), ("global", fill_v2.global_tiling(W, warps)) for 4, 8
    and 16 warps a CTA and, where W takes the shared tier, ("global", t)
    at the table's tiling t (the global tier's cost at one tiling)."""
    from ..dp import fill_v2

    out = [("smem", t) for t in smem_tilings(W)]
    kind, table = fill_v2.fill_route(W)
    for r in [("global", fill_v2.global_tiling(W, cap)) for cap in (4, 8, 16)
              ] + ([("global", table)] if kind == "smem" else []):
        if r not in out:
            out.append(r)
    return out


def long_read_batch(W: int, seed: int = 104, n: int = 2, rows: int = 8600):
    """n reads of about `rows` bases copied with errors from one random
    ref of W - rows - 1 bases, each in a full envelope (PairBatch.build
    adds a halo lane; reads that came out longer are cut to `rows`)."""
    import numpy as np

    from ..dp.engine import PairBatch
    from ..dp.scores import ScoreTables
    from ..envelope import full_envelope
    from ..io.fastseq import FastSeq
    from ..model.params import default_params

    tables = ScoreTables.from_params(default_params())
    rng = np.random.default_rng(seed)
    xlen = W - rows - 1
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, xlen))
    pairs = []
    for b in range(n):
        k = int(rng.integers(0, max(1, xlen - rows - rows // 10)))
        ys = []
        while len(ys) < rows and k < xlen:
            r = rng.random()
            if r < 0.072:  # substituted
                ys.append("ACGT"["ACGT".index(xs[k]) ^ int(rng.integers(1, 4))])
            elif r < 0.096:  # followed by an inserted base
                ys += [xs[k], "ACGT"[int(rng.integers(0, 4))]]
            elif r >= 0.12:  # kept (0.096-0.12: deleted)
                ys.append(xs[k])
            k += 1
        ys = ys[:rows]
        q = "".join(chr(33 + int(v)) for v in rng.integers(3, 40, len(ys)))
        pairs.append((FastSeq(name="x", seq=xs),
                      FastSeq(name=f"y{b}", seq="".join(ys), qual=q),
                      full_envelope(xlen, len(ys))))
    pb = PairBatch.build(pairs, tables)
    assert pb.member.shape[1] == W
    return pb, tables


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


def sweep(W: int, mode: str, rows: int = 8600, n: int = 2) -> dict:
    """{route: (ms, max abs error against the plain version, within K1's
    tolerance)} of every route of tier_routes(W) on n reads."""
    from ..dp import fill_v2
    from ..dp.engine import to_device

    pb, tables = long_read_batch(W, n=n, rows=rows)
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(tables, "cuda")
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode).double()
    fin = ref > fill_v2.NEG_INF / 2
    keys = []
    for i in range(4):
        k = inp["keys"].clone()
        k[:, i, 1] = (k[:, i, 1] + 1) % 40
        keys.append(k)
    out = {}
    for r in tier_routes(W):
        got = fill_v2.band_fill(**inp, tables=v2, mode=mode, route=r).double()
        err = (got - ref).abs()[fin]
        ok = bool((err <= ATOL + RTOL * ref[fin].abs()).all())
        out[r] = (_ms(lambda k: fill_v2.band_fill(
            **dict(inp, keys=k), tables=v2, mode=mode, route=r), keys),
            float(err.max()), ok)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("widths", type=int, nargs="+")
    ap.add_argument("--rows", type=int, default=8600)
    ap.add_argument("--modes", nargs="+", default=["viterbi", "forward"])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    from .. import kernels
    from ..dp import fill_v2
    from .chains import card_label

    kernels.library()
    card = card_label()
    print(card, flush=True)
    for W in args.widths:
        for mode in args.modes:
            res = sweep(W, mode, args.rows, args.pairs)
            lines = sorted(res.items(), key=lambda kv: kv[1][0])
            print(f"W={W} {mode} B={args.pairs} rows={args.rows} (table "
                  f"{fill_v2.fill_route(W)}): "
                  + "; ".join("{} {} x {} x {}: {:.3f} ({:.3g}{})".format(
                      kind, *t, ms, err, "" if ok else " !")
                      for (kind, t), (ms, err, ok) in lines)
                  + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
