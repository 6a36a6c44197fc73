"""Ceilings of this card for the banded row-loop kernels: the counterpart of
tools/prof/roofline_probe.py (P1).

    python -m quaff_tpu_torch.prof.roofline_probe      # on a CUDA card

(a) P1's dependent add+max and roll+add chains (csrc/sol_probe.cu, laid
    out as K1: one block per row, one thread per lane) at iters 64 and 256,
    GRID 512, on [256, 256] (the TPU tool's shape: about two blocks on each
    of the H100's 132 SMs) and [2048, 256] (K1's production batch, which
    fills the card); operations/s and ns per [B, W] step from the
    difference of the two (chains.marginal).
(b) K1's fill rate at the c8f30 self pair (read 0 of c8f30.fastq.gz
    without qualities against the same read, lane-packed) at B = 512, 1024,
    2048 and 4096: in-envelope cells/s and ms.
(c) K1 at B=2048 with the read cut to 2048, 4096 and 6656 rows: ms and
    cells/s, and the fit ms = intercept + slope * rows (slope: one row of
    the B pairs; intercept: the launch and the end reduction), over all
    cuts and over the cuts that pack to one width (the cut reads pack
    narrower than the whole one, and a narrower block changes how many
    blocks an SM holds, so only a line at one width separates the two).

Every printed line carries the card's name and power limit.  Unlike the
TPU tool this one varies no input between timed runs: that worked around
the TPU runtime's execution cache, and a CUDA card has none.
"""

from __future__ import annotations

import pathlib
import sys

import numpy as np
import torch

from ..dp import fill_v2
from ..dp.engine import PairBatch, to_device
from ..dp.scores import ScoreTables
from ..envelope import make_envelope
from ..io.fastseq import KmerIndex, read_fast_seqs
from ..model.params import default_params
from .chains import OPS_PER_ELEM, card_label, chain, cuda_time, marginal

DATA = pathlib.Path(__file__).resolve().parents[2] / "tests" / "data"
SHAPES = ((256, 256), (2048, 256))
GRID = 512
ITERS = (64, 256)
FILL_BATCHES = (512, 1024, 2048, 4096)
ROW_CUTS = (2048, 4096, 6656)
ROW_BATCH = 2048


def p1_inputs(B: int, W: int, device, seed: int = 7):
    """P1's a and b: standard normal float32 [B, W] from default_rng(7)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, W)).astype(np.float32)
    b = rng.standard_normal((B, W)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def chain_rates(op: str, a, b) -> dict:
    """The chain's times at the two iteration counts and its marginal
    step."""
    B, W = a.shape
    t_lo = cuda_time(chain, op, a, b, GRID, ITERS[0])
    t_hi = cuda_time(chain, op, a, b, GRID, ITERS[1])
    step, rate = marginal(t_lo, t_hi, ITERS[0], ITERS[1], GRID, B, W,
                          OPS_PER_ELEM[op])
    return {"op": op, "B": B, "W": W, "grid": GRID, "iters": ITERS,
            "t_lo": t_lo, "t_hi": t_hi, "step_s": step, "ops_per_s": rate}


def sol_chains() -> list:
    """(a): add_max and roll_add at each shape."""
    out = []
    for B, W in SHAPES:
        a, b = p1_inputs(B, W, "cuda")
        for op in ("add_max", "roll_add"):
            out.append(chain_rates(op, a, b))
    return out


def fill_inputs(B: int, device, max_rows: int | None = None):
    """K1's inputs for B copies of the c8f30 self pair with the read cut to
    max_rows rows, built as roofline_probe.py:114-121 builds them; returns
    (kernel inputs, tables, in-envelope cells of the batch)."""
    y = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    if max_rows is not None:
        y.seq, y.qual = y.seq[:max_rows], y.qual[:max_rows]
    x = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x.qual = ""
    tables = ScoreTables.from_params(default_params())
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=14, cell_size=24)
    pb = PairBatch.build_packed([(x, y, env)] * B, tables)
    inp = fill_v2.kernel_inputs(to_device(pb, device))
    return inp, fill_v2.V2Tables.from_tables(tables, device), env.num_cells * B


def _k1(inp, v2):
    return fill_v2.band_fill(**inp, tables=v2, mode="viterbi", local=True)


def fill_rates(batches=FILL_BATCHES, device="cuda",
               max_rows: int | None = None) -> list:
    """(b): K1's time and in-envelope cells/s at each batch size."""
    out = []
    for B in batches:
        inp, v2, cells = fill_inputs(B, device, max_rows)
        t = cuda_time(_k1, inp, v2)
        out.append({"B": B, "W": inp["doff"].shape[1], "s": t,
                    "cells": cells, "cells_per_s": cells / t})
    return out


def _line(pts):
    """(slope in s per row, intercept in s) of the least-squares line
    through the points' (rows, s)."""
    slope, intercept = np.polyfit([p["rows"] for p in pts],
                                  [p["s"] for p in pts], 1)
    return float(slope), float(intercept)


def row_costs(cuts=ROW_CUTS, B: int = ROW_BATCH, device="cuda"):
    """(c): K1 at B pairs with the read cut to each of `cuts` rows.
    Returns (points, fit, fits by width): the line through all points, and
    one line for each packed width that two or more cuts share (a cut read
    can pack to a narrower band, which changes the blocks an SM holds)."""
    pts = []
    for cut in cuts:
        inp, v2, cells = fill_inputs(B, device, cut)
        t = cuda_time(_k1, inp, v2)
        pts.append({"cut": cut, "rows": inp["keys"].shape[1],
                    "W": inp["doff"].shape[1], "s": t, "cells": cells,
                    "cells_per_s": cells / t})
    widths = sorted({p["W"] for p in pts})
    by_width = {w: _line([p for p in pts if p["W"] == w]) for w in widths
                if sum(p["W"] == w for p in pts) >= 2}
    return pts, _line(pts), by_width


def run(card: str, out=print) -> dict:
    """Parts (a), (b) and (c) on the card, each result printed with the
    card's label."""
    chains = sol_chains()
    for r in chains:
        out(f"[sol:{r['op']}] [{r['B']},{r['W']}] "
            f"{r['ops_per_s'] / 1e12:.3f} Tops/s ({r['step_s'] * 1e9:.3f} ns "
            f"per [{r['B']},{r['W']}] step; GRID {r['grid']}: "
            f"{r['iters'][0]}it {r['t_lo'] * 1e3:.3f} ms, "
            f"{r['iters'][1]}it {r['t_hi'] * 1e3:.3f} ms) [{card}]")
    fills = fill_rates()
    for r in fills:
        out(f"[fill B={r['B']}] {r['cells_per_s'] / 1e9:.3f} Gcells/s "
            f"({r['s'] * 1e3:.3f} ms, W={r['W']}, {r['cells']} cells) [{card}]")
    pts, fit, by_width = row_costs()
    for r in pts:
        out(f"[rows={r['cut']}] {r['rows']} rows: {r['s'] * 1e3:.3f} ms, "
            f"{r['cells_per_s'] / 1e9:.3f} Gcells/s (W={r['W']}, B="
            f"{ROW_BATCH}) [{card}]")
    for label, (slope, intercept) in [("all cuts", fit)] + [
            (f"W={w}", line) for w, line in by_width.items()]:
        out(f"[rows fit, {label}] ms = {intercept * 1e3:.3f} + "
            f"{slope * 1e6:.4f} us x rows (B={ROW_BATCH}) [{card}]")
    return {"chains": chains, "fills": fills, "rows": pts, "fit": fit,
            "fit_by_width": by_width}


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("roofline_probe: torch.cuda.is_available() is "
                         "false; the probe measures a CUDA card\n")
        return 1
    run(card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
