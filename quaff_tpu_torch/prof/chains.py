"""The probes' chain kernel (csrc/sol_probe.cu), its plain PyTorch version,
and the measuring helpers the probes share.

Each thread of the kernel runs grid * iters dependent steps of one op on
its lane of a [B, W] float32 block, from x = a (the TPU probes' first grid
step sets o_ref to a):

  add_max      x = max(x + a, b)                   (P1)
  roll_add     x = roll(x, 1, lanes) + a           (P1; x[w] = x[w-1] + a[w])
  lse_guarded  x = lse(x, a) as K1-K4 compute it   (P2's jnp.logaddexp chain)
  raw_lse      x = max(x, a) + log1p(exp(-|x - a|))        (P2)
  raw_lse_log  x = max(x, a) + log(1 + exp(-|x - a|))      (P2)

The TPU kernels are tools/prof/roofline_probe.py:78 (P1) and
tools/prof/sol_transcendental.py:29 (P2).
"""

from __future__ import annotations

import collections
import statistics
import subprocess

import torch

from ..dp.fill_v2 import _lse2, check_tensors

OPS = ("add_max", "roll_add", "lse_guarded", "raw_lse", "raw_lse_log")
# float32 operations an element-step counts against the data sheet's peak:
# the add and the max; the add (a lane move is no arithmetic); a
# log-add-exp as chip_smoke.py's OPS_PER_CELL counts one (max, subtract,
# abs, exp, log1p, add)
OPS_PER_ELEM = {"add_max": 2, "roll_add": 1, "lse_guarded": 6, "raw_lse": 6,
                "raw_lse_log": 6}
MAX_LANES = 1024  # one thread a lane, one block a row


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


def chain(op: str, a: torch.Tensor, b: torch.Tensor, grid: int, iters: int,
          x0: torch.Tensor | None = None) -> torch.Tensor:
    """grid * iters dependent steps of `op` on [B, W] float32 tensors, from
    x0 (default a): csrc/sol_probe.cu for CUDA tensors (each launch adds one
    to `chain.launches[op]`), the plain version for CPU tensors."""
    if op not in OPS:
        raise ValueError(f"chain: unknown op {op!r} (one of {OPS})")
    dev = a.device
    if dev.type == "cpu":
        return chain_reference(op, a, b, grid, iters, x0)
    if dev.type != "cuda":
        raise RuntimeError(f"chain: no kernel for device {dev}")
    from .. import kernels

    x0 = a if x0 is None else x0
    B, W = a.shape
    if not 1 <= W <= MAX_LANES:
        raise ValueError(f"chain: W={W} lanes, the kernel takes 1..{MAX_LANES}")
    check_tensors("chain", {
        "x0": (x0, torch.float32, (B, W)),
        "a": (a, torch.float32, (B, W)),
        "b": (b, torch.float32, (B, W)),
    }, dev)
    out = torch.empty_like(a)
    with torch.cuda.device(dev):
        err = kernels.library().quaff_sol_chain(
            OPS.index(op), x0.data_ptr(), a.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, W, grid, iters,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"chain kernel launch failed: {kernels.error_string(err)} "
            f"(op={op}, B={B}, W={W}, grid={grid}, iters={iters})")
    chain.launches[op] += 1
    return out


chain.launches = collections.Counter()


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
