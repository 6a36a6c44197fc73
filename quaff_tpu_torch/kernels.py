"""Build and load the port's CUDA kernels (csrc/*.cu).

At first use each source is compiled by its own nvcc process for sm_90a,
all started together, and the objects are linked into one shared library
with a plain C interface under build/quaff_tpu_torch/ (build.py), named by
a hash of the sources and flags.  The library is loaded with ctypes.  Only
the CUDA branches of the kernel wrappers import this module, so a host
without nvcc never reaches it.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import threading

from .build import BUILD_DIR, build_library, source_hash

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-shared"]

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


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources lives (built or not)."""
    files = _sources() + sorted(CSRC.glob("*.cuh"))
    h = source_hash(files, " ".join(NVCC_FLAGS + LINK_FLAGS))
    return BUILD_DIR / f"libquaff_kernels_{h}.so"


def library() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            build_log = build_library(path, _sources(), _nvcc(), NVCC_FLAGS,
                                      LINK_FLAGS)
        lib = ctypes.CDLL(str(path))
        p, i = ctypes.c_void_p, ctypes.c_int
        fill_args = [
            p, i, p, i, p,  # x_tok, Lx, keys, Ly, meta
            p, i, p, p, i,  # doff, W, seg_start, seg_width, S
            p, p, p, p, i, i,  # match, match_noq, insert, insert_noq, Km, Q
            p, i, p,  # ik, n_ik, trans
        ]
        lib.quaff_band_fill.argtypes = fill_args + [
            i, i, i,  # B, viterbi, local
            p, p, p,  # scratch, out, stream
        ]
        lib.quaff_band_fill_warp.argtypes = fill_args + [
            i, i, i, i,  # B, viterbi, local, lpt
            p, p,  # out, stream
        ]
        lib.quaff_band_fill_cluster.argtypes = fill_args + [
            i, i, i,  # B, viterbi, local
            i, i, i,  # lpt, nct, warps
            p, p,  # out, stream
        ]
        lib.quaff_fwd_store.argtypes = fill_args + [
            i, i,  # B, local
            p, p, p, p, p,  # scratch, out, rows, offs, stream
        ]
        lib.quaff_fwd_store_warp.argtypes = [
            p, i, p, i, p,  # x_tok, Lx, keys, Ly, meta
            p, i,  # doff, W
            p, p, p, p, i, i,  # match, match_noq, insert, insert_noq, Km, Q
            p, i, p,  # ik, n_ik, trans
            i, i, i,  # B, local, lpt
            p, p, p, p,  # out, rows, offs, stream
        ]
        lib.quaff_bwd_counts_warp.argtypes = [
            p, i, p, i, p,  # x_tok, Lx, keys, Ly, meta
            p, i,  # doff, W
            p, p, p, p, i, i,  # match, match_noq, insert, insert_noq, Km, Q
            p, i, p,  # ik, n_ik, trans
            p, p, p, i, i, i,  # wrow, rows, offs, B, local, lpt
            p, p, p,  # partial, d_sc, stream
        ]
        lib.quaff_bwd_counts.argtypes = [
            p, i, p, i, p,  # x_tok, Lx, keys, Ly, meta
            p, i,  # doff, W
            p, p, p, p, i, i,  # match, match_noq, insert, insert_noq, Km, Q
            p, i, p,  # ik, n_ik, trans
            p, p, p, i, i,  # wrow, rows, offs, B, local
            p, p, p, p,  # scratch, partial, d_sc, stream
        ]
        lib.quaff_estep_reduce.argtypes = [p, i, i, p, p]
        lib.quaff_ov_fill_warp.argtypes = [
            p, i, i, p,  # bank, C, L, meta
            p, i, p, p, i,  # doff, W, seg_start, seg_width, S
            p, p, i, i, p, p,  # ins_xy, trans, B, lpt, out, stream
        ]
        lib.quaff_ov_fill_cluster.argtypes = [
            p, i, i, p,  # bank, C, L, meta
            p, i, p, p, i,  # doff, W, seg_start, seg_width, S
            p, p, i,  # ins_xy, trans, B
            i, i, i,  # lpt, nct, warps
            p, p,  # out, stream
        ]
        lib.quaff_sol_chain.argtypes = [
            i, p, p, p, p,  # op, x0, a, b, out
            i, i, i, i, p,  # B, W, grid, iters, stream
        ]
        for fn in ("quaff_band_fill", "quaff_band_fill_warp",
                   "quaff_band_fill_cluster",
                   "quaff_fwd_store", "quaff_bwd_counts",
                   "quaff_fwd_store_warp", "quaff_bwd_counts_warp",
                   "quaff_estep_reduce", "quaff_ov_fill_warp",
                   "quaff_ov_fill_cluster",
                   "quaff_sol_chain"):
            getattr(lib, fn).restype = i
        for fn in ("quaff_band_fill_max_smem_lanes",
                   "quaff_bwd_counts_max_smem_lanes"):
            getattr(lib, fn).argtypes = [i]
            getattr(lib, fn).restype = i
        lib.quaff_cuda_error_string.argtypes = [i]
        lib.quaff_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def max_smem_lanes(device_index: int, kernel: str = "band_fill") -> int:
    """Widest band a block-route kernel ("band_fill", which K2 shares, or
    "bwd_counts") keeps in shared memory on this card."""
    key = (device_index, kernel)
    if key not in _smem_lanes:
        fn = getattr(library(), f"quaff_{kernel}_max_smem_lanes")
        _smem_lanes[key] = int(fn(device_index))
    return _smem_lanes[key]


def error_string(err: int) -> str:
    return library().quaff_cuda_error_string(err).decode()


def check_launch(err: int, name: str, route, shape: str) -> None:
    """Raise RuntimeError where a kernel entry returned a CUDA error (a
    refused or failed launch of `name` on `route`, (kind, arg))."""
    if err != 0:
        kind, arg = route
        raise RuntimeError(f"{name} kernel launch failed ({kind} route {arg}): "
                           f"{error_string(err)} ({shape})")
