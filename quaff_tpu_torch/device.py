"""Explicit device resolution for the port (the counterpart of quaff_tpu's
QUAFF_TPU_PLATFORM / jax.config platform pinning).

QUAFF_TORCH_DEVICE names the device ("cuda" by default, "cpu" for the
plain-PyTorch versions of the kernels).  Asking for CUDA on a host without
a usable card raises: the port never carries on silently on the CPU.
"""

from __future__ import annotations

import contextlib
import os
import threading

import torch

# Full-f32 matmuls and convolutions: TF32 keeps about three decimal digits,
# far below the kernels' parity tolerances.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

ENV_VAR = "QUAFF_TORCH_DEVICE"
DEFAULT_DEVICE = "cuda"


def resolve_device(name=None) -> torch.device:
    """torch.device for `name`, else $QUAFF_TORCH_DEVICE, else "cuda"."""
    if isinstance(name, torch.device):
        dev = name
    else:
        dev = torch.device(name or os.environ.get(ENV_VAR) or DEFAULT_DEVICE)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{ENV_VAR}={dev} asks for a CUDA device, but "
            "torch.cuda.is_available() is false on this host; set "
            f"{ENV_VAR}=cpu to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev} (use cuda or cpu)")
    return dev


_THREADS_LOCK = threading.Lock()
_threads_saved = []  # [count before the outermost guard, depth]


@contextlib.contextmanager
def one_thread_on_cpu(dev: torch.device):
    """Run the body with one intra-op thread when `dev` is the CPU, and
    restore the count after.  The CPU paths step small tensors row by row
    (the kernels' plain versions, the exact engine): more threads only
    add synchronisation, and beside other busy processes they made each
    row many times slower.  Nested and concurrent uses (a server's
    threads) restore the count once, after the last one leaves."""
    if dev.type != "cpu":
        yield
        return
    with _THREADS_LOCK:
        if not _threads_saved:
            _threads_saved[:] = [torch.get_num_threads(), 0]
            torch.set_num_threads(1)
        _threads_saved[1] += 1
    try:
        yield
    finally:
        with _THREADS_LOCK:
            _threads_saved[1] -= 1
            if _threads_saved[1] == 0:
                torch.set_num_threads(_threads_saved[0])
                _threads_saved.clear()
