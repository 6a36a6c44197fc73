"""What a log-add-exp costs on this card: the counterpart of
tools/prof/sol_transcendental.py (P2).

    python -m quaff_tpu_torch.prof.sol_transcendental      # on a CUDA card

- The three lse chains of csrc/sol_probe.cu (lse_guarded, the log-add-exp
  K1-K4 run; raw_lse; raw_lse_log) at iters 64 and 256, GRID 512, at
  [256, 256] and [2048, 256] (the warp layout, 8 lanes a thread), and
  lse_guarded at P1's route shapes (roofline_probe.ROUTE_SHAPES, each on
  K1's layout at its width, at its GRID), with P2's inputs (a * 0.1 and -|b|
  from default_rng(7)): ns per [B, W] step and the cost as a multiple of
  one add_max step measured by P1 at the same shape and GRID (the TPU
  tool divided by a constant taken on the TPU).
- P2's element check: on 8192 seeded values with float32-minimum sentinels
  at every 7th and 11th element, the kernel's guarded lse against
  torch.logaddexp and against the kernel's raw forms: bitwise equal or
  not, and the largest difference in ulps.

Every printed line carries the card's name and power limit.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .chains import OPS_PER_ELEM, card_label, chain
from .roofline_probe import (GRID, ROUTE_SHAPES, SHAPES, chain_rates,
                             p1_inputs, route_name)

LSE_OPS = ("lse_guarded", "raw_lse", "raw_lse_log")
NEG = float(np.finfo(np.float32).min)


def p2_inputs(B: int, W: int, device, seed: int = 7):
    """P2's a * 0.1 and -|b|, float32 [B, W] from default_rng(7)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((B, W)).astype(np.float32) * np.float32(0.1)
    b = -np.abs(rng.standard_normal((B, W))).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def lse_costs(add_max_step=None) -> list:
    """Each lse chain's marginal step at P1's shapes and lse_guarded's at
    its route shapes, and its cost in add_max steps; add_max_step maps (B,
    W) to P1's measured step at that shape's GRID (measured here where it
    is missing)."""
    add_max_step = dict(add_max_step or {})
    out = []
    cases = ([(B, W, GRID, LSE_OPS) for B, W in SHAPES]
             + [(B, W, grid, ("lse_guarded",)) for B, W, grid in ROUTE_SHAPES])
    for B, W, grid, ops in cases:
        if (B, W) not in add_max_step:
            add_max_step[(B, W)] = chain_rates(
                "add_max", *p1_inputs(B, W, "cuda"), grid)["step_s"]
        a, b = p2_inputs(B, W, "cuda")
        for op in ops:
            r = chain_rates(op, a, b, grid)
            r["add_max_steps"] = r["step_s"] / add_max_step[(B, W)]
            out.append(r)
    return out


def ulps(x: torch.Tensor, y: torch.Tensor) -> int:
    """Largest distance between float32 x and y in units in the last place
    (the bit patterns as integers ordered like the floats)."""
    def key(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((key(x) - key(y)).abs().max())


def element_check(device="cuda", n: int = 8192, seed: int = 7) -> dict:
    """P2's check: the kernel's guarded lse(a, b), one step from x0 = a,
    against torch.logaddexp(a, b) and the kernel's raw forms."""
    rng = np.random.default_rng(seed)
    av = (rng.standard_normal(n) * 30).astype(np.float32)
    av[::7] = NEG
    bv = (rng.standard_normal(n) * 30).astype(np.float32)
    bv[::11] = NEG
    a = torch.from_numpy(av.reshape(-1, 256)).to(device)
    b = torch.from_numpy(bv.reshape(-1, 256)).to(device)
    unused = torch.zeros_like(a)
    guarded = chain("lse_guarded", b, unused, 1, 1, x0=a)
    others = {"torch.logaddexp": torch.logaddexp(a, b)}
    for op in ("raw_lse", "raw_lse_log"):
        others[op] = chain(op, b, unused, 1, 1, x0=a)
    return {name: {"bitwise": bool(torch.equal(guarded, v)),
                   "max_ulps": ulps(guarded, v)}
            for name, v in others.items()}


def run(card: str, out=print, add_max_step=None) -> dict:
    """The lse chains and the element check on the card, each result
    printed with the card's label."""
    costs = lse_costs(add_max_step=add_max_step)
    for r in costs:
        out(f"[{r['op']}] [{r['B']},{r['W']}] {route_name(r['route'])}: "
            f"{r['step_s'] * 1e9:.3f} ns per "
            f"step = {r['add_max_steps']:.2f} add_max steps "
            f"({r['ops_per_s'] / 1e12:.3f} Tops/s at {OPS_PER_ELEM[r['op']]} "
            f"ops; GRID {r['grid']}: {r['iters'][0]}it "
            f"{r['t_lo'] * 1e3:.3f} ms, {r['iters'][1]}it "
            f"{r['t_hi'] * 1e3:.3f} ms) [{card}]")
    check = element_check()
    for name, c in check.items():
        out(f"[lse check] kernel lse_guarded vs {name}: bitwise equal "
            f"{c['bitwise']}, max {c['max_ulps']} ulps (8192 values, "
            f"float32-min sentinels) [{card}]")
    return {"costs": costs, "check": check}


def main() -> int:
    if not torch.cuda.is_available():
        sys.stderr.write("sol_transcendental: torch.cuda.is_available() is "
                         "false; the probe measures a CUDA card\n")
        return 1
    run(card_label())
    return 0


if __name__ == "__main__":
    sys.exit(main())
