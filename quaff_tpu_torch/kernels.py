"""Build and load the port's CUDA kernels (csrc/*.cu).

At first use the sources are compiled by nvcc for sm_90a into one shared
library with a plain C interface, under build/quaff_tpu_torch/ in the
checkout, named by a hash of the sources and flags (a changed source
builds anew; an unchanged one is reused).  The library is loaded with
ctypes.  Only the CUDA branches of the kernel wrappers import this module,
so a host without nvcc never reaches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "quaff_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_lib = None
_smem_lanes: dict = {}
# what this process's build printed (nvcc's -Xptxas -v register and
# shared memory report); None when an earlier build was reused
build_log = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from csrc/ at first use"
    )


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libquaff_kernels_{h.hexdigest()[:16]}.so"


def _build(path: pathlib.Path) -> None:
    global build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in sorted(CSRC.glob("*.cu"))]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
            f"{res.stderr}"
        )
    os.replace(tmp, path)


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.quaff_band_fill.argtypes = [
            p, i, p, i, p,  # x_tok, Lx, keys, Ly, meta
            p, i, p, p, i,  # doff, W, seg_start, seg_width, S
            p, p, p, p, i, i,  # match, match_noq, insert, insert_noq, Km, Q
            p, i, p,  # ik, n_ik, trans
            i, i, i,  # B, viterbi, local
            p, p, p,  # scratch, out, stream
        ]
        lib.quaff_band_fill.restype = i
        lib.quaff_band_fill_max_smem_lanes.argtypes = [i]
        lib.quaff_band_fill_max_smem_lanes.restype = i
        lib.quaff_cuda_error_string.argtypes = [i]
        lib.quaff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def max_smem_lanes(device_index: int) -> int:
    """Widest band K1 keeps in shared memory on this card."""
    if device_index not in _smem_lanes:
        _smem_lanes[device_index] = int(
            library().quaff_band_fill_max_smem_lanes(device_index)
        )
    return _smem_lanes[device_index]


def error_string(err: int) -> str:
    return library().quaff_cuda_error_string(err).decode()
