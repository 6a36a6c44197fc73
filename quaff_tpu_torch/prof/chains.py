"""The probes' chain kernel (csrc/sol_probe.cu), its plain PyTorch version,
and the measuring helpers the probes share.

The kernel runs grid * iters dependent steps of one op on every lane of a
[B, W] float32 block, from x = a (the TPU probes' first grid step sets
o_ref to a):

  add_max      x = max(x + a, b)                   (P1)
  roll_add     x = roll(x, 1, lanes) + a           (P1; x[w] = x[w-1] + a[w])
  lse_guarded  x = lse(x, a) as K1-K4 compute it   (P2's jnp.logaddexp chain)
  raw_lse      x = max(x, a) + log1p(exp(-|x - a|))        (P2)
  raw_lse_log  x = max(x, a) + log(1 + exp(-|x - a|))      (P2)

Each row is laid out at K1's tiling for a band of W lanes
(fill_v2.fill_route, chain_route): the warp layout (one warp a row, the
lanes in registers), the cluster layout (a thread-block cluster, the lanes
in registers) or the smem layout (up to 16 CTAs, each thread's run of lanes
in shared memory, or past what a CTA holds in a per-row slab of global
memory, the global tier), so a step costs what K1's row exchange costs at
that width.

The TPU kernels are tools/prof/roofline_probe.py:78 (P1) and
tools/prof/sol_transcendental.py:29 (P2).
"""

from __future__ import annotations

import collections
import statistics
import subprocess

import torch

from ..dp.fill_v2 import _lse2, check_tensors, fill_route

OPS = ("add_max", "roll_add", "lse_guarded", "raw_lse", "raw_lse_log")
# float32 operations an element-step counts against the data sheet's peak:
# the add and the max; the add (a lane move is no arithmetic); a
# log-add-exp as chip_smoke.py's OPS_PER_CELL counts one (max, subtract,
# abs, exp, log1p, add)
OPS_PER_ELEM = {"add_max": 2, "roll_add": 1, "lse_guarded": 6, "raw_lse": 6,
                "raw_lse_log": 6}
# bytes a lane of the smem layouts' run: x, a and b (kSolLaneBytes)
SOL_LANE_BYTES = 12


def _raw_lse(x, a):
    return torch.maximum(x, a) + torch.log1p(torch.exp(-(x - a).abs()))


def _raw_lse_log(x, a):
    return torch.maximum(x, a) + torch.log(1.0 + torch.exp(-(x - a).abs()))


_STEPS = {
    "add_max": lambda x, a, b: torch.maximum(x + a, b),
    "roll_add": lambda x, a, b: torch.roll(x, 1, dims=1) + a,
    "lse_guarded": lambda x, a, b: _lse2(x, a),
    "raw_lse": lambda x, a, b: _raw_lse(x, a),
    "raw_lse_log": lambda x, a, b: _raw_lse_log(x, a),
}


def chain_reference(op: str, a: torch.Tensor, b: torch.Tensor, grid: int,
                    iters: int, x0: torch.Tensor | None = None) -> torch.Tensor:
    """The plain version of `chain`: grid * iters steps of `op`."""
    step = _STEPS[op]
    x = a if x0 is None else x0
    for _ in range(grid * iters):
        x = step(x, a, b)
    return x


def chain_route(W: int) -> tuple:
    """The layout of a row of W lanes: K1's route and tiling for a band of
    W lanes (fill_v2.fill_route), ("warp", lpt), ("cluster", (nct, warps,
    lpt)), ("smem", ...) or ("global", ...)."""
    return fill_route(W)


def slab_bytes(B: int, tiling) -> int:
    """The global tier's slab for B rows at `tiling` (nct, warps, lpt):
    every CTA's run, SOL_LANE_BYTES a lane."""
    nct, warps, lpt = tiling
    return B * nct * warps * 32 * lpt * SOL_LANE_BYTES


def chain(op: str, a: torch.Tensor, b: torch.Tensor, grid: int, iters: int,
          x0: torch.Tensor | None = None) -> torch.Tensor:
    """grid * iters dependent steps of `op` on [B, W] float32 tensors (W >=
    1), from x0 (default a): csrc/sol_probe.cu at chain_route(W)'s layout
    for CUDA tensors (each launch adds one to `chain.launches[op]` and to
    `chain.layout_launches[(op, kind)]`), the plain version for CPU
    tensors.  Raises on a refused or failed launch."""
    if op not in OPS:
        raise ValueError(f"chain: unknown op {op!r} (one of {OPS})")
    if a.dim() != 2:
        raise ValueError(f"chain: a must be [B, W], got shape "
                         f"{tuple(a.shape)}")
    B, W = a.shape
    if W < 1:
        raise ValueError(f"chain: W={W} lanes; the chain takes W >= 1")
    if grid < 0 or iters < 0:
        raise ValueError(f"chain: grid={grid}, iters={iters} must be >= 0")
    x0 = a if x0 is None else x0
    dev = a.device
    check_tensors("chain", {
        "x0": (x0, torch.float32, (B, W)),
        "a": (a, torch.float32, (B, W)),
        "b": (b, torch.float32, (B, W)),
    }, dev)
    if dev.type == "cpu":
        return chain_reference(op, a, b, grid, iters, x0)
    if dev.type != "cuda":
        raise RuntimeError(f"chain: no kernel for device {dev}")
    from .. import kernels

    kind, tiling = chain_route(W)
    lib = kernels.library()
    out = torch.empty_like(a)
    args = (OPS.index(op), x0.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, W, grid, iters)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kind == "warp":
            err = lib.quaff_sol_chain_warp(*args, tiling, stream)
        elif kind == "cluster":
            nct, warps, lpt = tiling
            err = lib.quaff_sol_chain_cluster(*args, lpt, nct, warps, stream)
        else:
            nct, warps, lpt = tiling
            nbytes = slab_bytes(B, tiling) if kind == "global" else 0
            slab = (torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
                    if kind == "global" else None)
            err = lib.quaff_sol_chain_smem(
                *args, lpt, nct, warps,
                None if slab is None else slab.data_ptr(), nbytes, stream)
    if err != 0:
        raise RuntimeError(
            f"chain kernel launch failed: {kernels.error_string(err)} "
            f"(op={op}, B={B}, W={W}, {kind} {tiling}, grid={grid}, "
            f"iters={iters})")
    chain.launches[op] += 1
    chain.layout_launches[(op, kind)] += 1
    return out


chain.launches = collections.Counter()
chain.layout_launches = collections.Counter()


def marginal(t_lo: float, t_hi: float, iters_lo: int, iters_hi: int,
             grid: int, B: int, W: int, ops_per_elem: int):
    """(seconds per dependent [B, W] step, operations per second) from the
    times of two chains that differ only in iters: the difference cancels
    the launch, the loads and the store (roofline_probe.py:94-103)."""
    step = (t_hi - t_lo) / (iters_hi - iters_lo) / grid
    return step, ops_per_elem * B * W / step


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def cuda_time(fn, *args, runs: int = 3) -> float:
    """Median seconds of fn(*args) over `runs` runs after one warm-up, by
    CUDA events around each run.  The tensors among args (also inside
    dicts, lists and tuples) must lie on a CUDA card: a measurement never
    falls back to the CPU."""
    tensors = list(_tensors(args))
    if not tensors or any(t.device.type != "cuda" for t in tensors):
        raise RuntimeError("cuda_time measures on a CUDA card: every tensor "
                           "argument must lie on one")
    fn(*args)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


def card_label() -> str:
    """The card's name and power limit as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them (its first card)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()
