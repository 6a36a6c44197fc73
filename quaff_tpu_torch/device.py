"""Explicit device resolution for the port (the counterpart of quaff_tpu's
QUAFF_TPU_PLATFORM / jax.config platform pinning).

QUAFF_TORCH_DEVICE names the device ("cuda" by default, "cpu" for the
plain-PyTorch versions of the kernels).  Asking for CUDA on a host without
a usable card raises: the port never carries on silently on the CPU.
"""

from __future__ import annotations

import os

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
