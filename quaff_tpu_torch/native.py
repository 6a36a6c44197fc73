"""ctypes bindings for the port's host library (libquaffio).

The port's own copy of the bindings it calls from quaff_tpu/native.py:
FASTA/FASTQ parsing, the envelope k-mer/diagonal seeding, the float64
banded refill and Viterbi traceback of the align winners, the overlap
model's truncated log-sum-exp table chain and its float64 banded fills,
strip scores and tracebacks (native/overlapdp.cpp, tracebackdp.cpp), and
(through model/negbinom.py) the negative-binomial null-model sums.

The library is compiled at first use from the repository's native/*.cpp
with g++ into build/quaff_tpu_torch/ (build.py), with the flags of
native/Makefile: -ffp-contract=off is required for bitwise parity with
the Python and reference arithmetic, and -march=native suits a library
built on the machine that runs it.  A failed build raises with g++'s
output, so every binding below has the library or raises; none of them
returns None for a missing library.  The JAX package's
quaff_tpu/libquaffio.so is never loaded.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import threading
from typing import List, Optional, Tuple

import numpy as np

from .build import BUILD_DIR, ROOT, build_library, source_hash

NATIVE_SRC = ROOT / "native"
SOURCES = ("quaffio.cpp", "overlapdp.cpp", "tracebackdp.cpp",
           "negbinomnat.cpp")
# native/Makefile:9 (CXXFLAGS) and :10 (LDFLAGS, without -shared)
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fopenmp-simd",
            "-std=c++17", "-fPIC", "-Wall"]
LDFLAGS = ["-shared", "-lz"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
# what this process's build printed; None when an earlier build was reused
build_log: Optional[str] = None


def _cpu_flags() -> str:
    """The host CPU's feature flags: -march=native builds are per machine."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line
    except OSError:
        pass
    return ""


def library_path() -> pathlib.Path:
    files = [NATIVE_SRC / s for s in SOURCES] + sorted(NATIVE_SRC.glob("*.h"))
    h = source_hash(files, " ".join(CXXFLAGS + LDFLAGS), _cpu_flags())
    return BUILD_DIR / f"libquaffio_{h}.so"


def _alloc_outputs(shapes) -> list:
    """f64 output buffers with MADV_HUGEPAGE suppressed: first-touch
    page compaction of huge pages stalls the fill for seconds, and the
    matrices are short-lived scratch."""
    try:
        from numpy._core import multiarray as _ma

        prev = _ma._set_madvise_hugepage(False)
    except Exception:  # pragma: no cover - numpy internals moved
        _ma, prev = None, None
    try:
        return [np.empty(s, np.float64) for s in shapes]
    finally:
        if _ma is not None:
            _ma._set_madvise_hugepage(prev)


def build() -> pathlib.Path:
    """Build the library for the current sources if it is missing."""
    global build_log
    path = library_path()
    if not path.exists():
        build_log = build_library(
            path, [NATIVE_SRC / s for s in SOURCES],
            os.environ.get("CXX", "g++"), CXXFLAGS, LDFLAGS,
        )
    return path


def get_lib() -> ctypes.CDLL:
    """The host library, built on first use (raises if the build fails)."""
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        c_i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32, i64, f64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_double
        lib.qio_open.restype = ctypes.c_void_p
        lib.qio_open.argtypes = [ctypes.c_char_p]
        lib.qio_error.restype = ctypes.c_char_p
        lib.qio_error.argtypes = [ctypes.c_void_p]
        lib.qio_num_seqs.restype = i64
        lib.qio_num_seqs.argtypes = [ctypes.c_void_p]
        for fn in ("qio_name", "qio_comment", "qio_seq", "qio_qual"):
            getattr(lib, fn).restype = ctypes.c_char_p
            getattr(lib, fn).argtypes = [ctypes.c_void_p, i64]
        for fn in ("qio_seq_len", "qio_qual_len", "qio_filepos"):
            getattr(lib, fn).restype = i64
            getattr(lib, fn).argtypes = [ctypes.c_void_p, i64]
        lib.qio_close.restype = None
        lib.qio_close.argtypes = [ctypes.c_void_p]
        lib.qio_diag_kmer_counts.restype = i64
        lib.qio_diag_kmer_counts.argtypes = [
            c_i32p, i64, c_i32p, i64, i32, i64p, i64p,
        ]
        lib.qio_diag_kmer_index.restype = None
        lib.qio_diag_kmer_index.argtypes = [c_i32p, i64, i32, c_i32p, c_i32p]
        lib.qio_diag_kmer_counts_indexed.restype = i64
        lib.qio_diag_kmer_counts_indexed.argtypes = [
            c_i32p, i64, i64, i32, c_i32p, c_i32p, i64p, i64p,
        ]
        lib.qdp_viterbi_traceback.restype = i64
        lib.qdp_viterbi_traceback.argtypes = [
            c_i32p, i64,  # x_tok, x_len
            c_i32p, c_i32p, c_i32p, c_i32p, i64, i32,  # y side
            i64, i64, i64,  # n_rows, d_lo, W
            f64p, f64p, f64p, f64p, i64, i64,  # emission tables, Km, Q
            f64p, f64p, f64p, f64p,  # m2m/m2i/m2d/m2e
            f64, f64, f64, f64,  # d2d, d2m, i2i, i2m
            i32,  # local
            f64p, f64p, f64p,  # mat, ins, del
            c_i32p, c_i32p, i64p,  # col_x, col_y, bounds
        ]
        lib.qdp_align_viterbi_path.restype = i64
        lib.qdp_align_viterbi_path.argtypes = [
            c_i32p, i64,  # x_tok, x_len
            c_i32p, c_i32p, c_i32p, c_i32p, i64, i32,  # y side
            i64, i64, u8p,  # d_lo, W, member
            f64p, f64p, f64p, f64p, i64, i64,  # emission tables, Km, Q
            f64p, f64p, f64p, f64p,  # m2m/m2i/m2d/m2e
            f64, f64, f64, f64,  # d2d, d2m, i2i, i2m
            i32,  # local
            f64p,  # score out
            c_i32p, c_i32p, i64p,  # col_x, col_y, bounds
        ]
        common = [
            c_i32p, i64,  # x_tok, x_len
            c_i32p, c_i32p, c_i32p, c_i32p, i64, i32,  # y side
            i64,  # n_rows
            i64, i64, u8p,  # d_lo, W, member
            f64p, f64p, f64p, f64p, i64, i64,  # emission tables, Km, Q
            f64p, f64p, f64p, f64p,  # m2m/m2i/m2d/m2e
            f64, f64, f64, f64,  # d2d, d2m, i2i, i2m
            i32, i32,  # mode, local
        ]
        lib.qdp_align_fill.restype = None
        lib.qdp_align_fill.argtypes = common + [f64p, f64p, f64p, f64p]
        lib.qdp_align_score.restype = None
        lib.qdp_align_score.argtypes = common + [f64p]  # end only
        lib.qref_lse_chain.restype = None
        lib.qref_lse_chain.argtypes = [f64p, f64p, i64, i64]
        ov_tabs = [
            f64p, f64p, f64p, f64p, i64, i64,  # pair tables, Km, Q
            f64p, f64p, f64p, i64,  # m2m/m2i/m2d, Ki
            f64p,  # trans6
        ]
        ov_common = [
            c_i32p, c_i32p, c_i32p, i64, i32,  # x side
            c_i32p, c_i32p, c_i32p, i64, i32,  # y side
            i64, i64,  # j_off, n_rows
            i64, i64, u8p,  # d_lo, W, member
        ] + ov_tabs
        lib.qdp_overlap_fill.restype = None
        lib.qdp_overlap_fill.argtypes = ov_common + [f64p, f64p, f64p, f64p]
        lib.qdp_overlap_score.restype = None
        lib.qdp_overlap_score.argtypes = ov_common + [f64p]  # end only
        lib.qdp_overlap_traceback.restype = i64
        lib.qdp_overlap_traceback.argtypes = [
            c_i32p, c_i32p, c_i32p, i64, i32,  # x side
            c_i32p, c_i32p, c_i32p, i64, i32,  # y side
            i64, i64, i64, i64,  # row_off, n_rows, d_lo, W
        ] + ov_tabs + [
            f64p, f64p, f64p,  # mat, ins, del
            c_i32p, c_i32p, i64p,  # col_x, col_y, bounds
        ]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.qdp_overlap_viterbi_path_batch.restype = None
        lib.qdp_overlap_viterbi_path_batch.argtypes = [
            i64,  # n_tasks
            u64p, i64p, c_i32p,  # xyptr [n,7], geom [n,6], hasq [n,2]
            u64p, i64p,  # tabptr [n,8], tabdim [n,3]
            u64p, f64p, i64p, i64p,  # colptr [n,2], end, bounds [n,4], ret
        ]
        _LIB = lib
        return lib


def available() -> bool:
    """True: the library is built on first use, or this raises."""
    get_lib()
    return True


def read_fast_seqs_native(filename: str) -> List["FastSeq"]:
    """Parse a sequence file with the native parser."""
    lib = get_lib()
    from .io.fastseq import FastSeq

    h = lib.qio_open(filename.encode())
    try:
        err = lib.qio_error(h)
        if err:
            raise IOError(f"{filename}: {err.decode()}")
        out: List[FastSeq] = []
        for i in range(lib.qio_num_seqs(h)):
            seq_len = lib.qio_seq_len(h, i)
            qual_len = lib.qio_qual_len(h, i)
            out.append(FastSeq(
                name=lib.qio_name(h, i).decode("latin-1"),
                comment=lib.qio_comment(h, i).decode("latin-1"),
                seq=ctypes.string_at(lib.qio_seq(h, i), seq_len).decode("latin-1"),
                qual=ctypes.string_at(lib.qio_qual(h, i), qual_len).decode("latin-1")
                if qual_len == seq_len and seq_len > 0
                else "",
                filename=filename,
                filepos=lib.qio_filepos(h, i),
            ))
        return out
    finally:
        lib.qio_close(h)


def _align_tabs(tables):
    tabs = getattr(tables, "_native_tabs", None)
    if tabs is None:
        tabs = {
            k: np.ascontiguousarray(getattr(tables, k), dtype=np.float64)
            for k in ("match_score", "match_score_noq", "insert_score",
                      "insert_score_noq", "m2m", "m2i", "m2d", "m2e")
        }
        tables._native_tabs = tabs
    return tabs


def _p32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _p64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _align_batch_call(fn, batch, tables, mode, local, threads, outputs):
    """One native fill call per pair of a PairBatch on a thread pool; the
    caller's outputs(b) gives the pair's output pointers."""
    from concurrent.futures import ThreadPoolExecutor

    tabs = _align_tabs(tables)
    Km, Q = tabs["match_score"].shape[1], tabs["match_score"].shape[2]
    B, W = batch.member.shape
    x_tok = np.ascontiguousarray(batch.x_tok, np.int32)
    y_tok = np.ascontiguousarray(batch.y_tok, np.int32)
    y_mk = np.ascontiguousarray(batch.y_match_kmer, np.int32)
    y_ik = np.ascontiguousarray(batch.y_indel_kmer_pad, np.int32)
    y_q = np.ascontiguousarray(batch.y_qual, np.int32)
    member = np.ascontiguousarray(batch.member, np.uint8)

    def run(b):
        fn(
            _p32(x_tok[b]), int(batch.x_len[b]),
            _p32(y_tok[b]), _p32(y_mk[b]), _p32(y_ik[b]), _p32(y_q[b]),
            int(batch.y_len[b]), int(batch.y_has_qual[b]),
            batch.max_y_len,
            int(batch.d_lo[b]), W,
            member[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            _p64(tabs["match_score"]), _p64(tabs["match_score_noq"]),
            _p64(tabs["insert_score"]), _p64(tabs["insert_score_noq"]),
            Km, Q,
            _p64(tabs["m2m"]), _p64(tabs["m2i"]), _p64(tabs["m2d"]),
            _p64(tabs["m2e"]),
            float(tables.d2d), float(tables.d2m),
            float(tables.i2i), float(tables.i2m),
            0 if mode == "viterbi" else 1, int(bool(local)),
            *outputs(b),
        )

    n_threads = min(B, threads if threads else (os.cpu_count() or 1))
    if n_threads <= 1:
        for b in range(B):
            run(b)
    else:
        with ThreadPoolExecutor(n_threads) as ex:
            list(ex.map(run, range(B)))


def align_fill_native(batch, tables, mode: str = "viterbi",
                      local: bool = True, threads: Optional[int] = None) -> dict:
    """Exact banded read-vs-ref fill for a PairBatch, one C call per pair
    on a thread pool: the contract of dp.engine.dp_fill with
    return_matrices=True, as host numpy.  threads caps the pool."""
    lib = get_lib()
    B, W = batch.member.shape
    R = batch.max_y_len
    mat, ins, dele = _alloc_outputs([(B, R + 1, W)] * 3)
    end = np.empty(B, np.float64)
    _align_batch_call(
        lib.qdp_align_fill, batch, tables, mode, local, threads,
        lambda b: (_p64(mat[b]), _p64(ins[b]), _p64(dele[b]), _p64(end[b:])),
    )
    return {"score": end, "mat": mat, "ins": ins, "del": dele}


def align_score_native(batch, tables, mode: str = "viterbi",
                       local: bool = True, threads: Optional[int] = None):
    """Score-only banded fills for a PairBatch: end scores [B] float64,
    bitwise equal to align_fill_native's in Viterbi mode."""
    lib = get_lib()
    end = np.empty(batch.member.shape[0], np.float64)
    _align_batch_call(lib.qdp_align_score, batch, tables, mode, local,
                      threads, lambda b: (_p64(end[b:]),))
    return end


def align_viterbi_path_cols(
    x_tok, x_len, y_tok, y_mk, y_ik_pad, y_q, y_len, y_has_qual,
    tables, local, d_lo, W, member,
):
    """Checkpointed fill + traceback in one native call.  Returns (col_x,
    col_y, x_start, x_end, score) with score bitwise equal to the full
    fill's end score.  Raises on a broken traceback."""
    lib = get_lib()
    tabs = _align_tabs(tables)
    Km, Q = tabs["match_score"].shape[1], tabs["match_score"].shape[2]

    def p32(a):
        return _p32(np.ascontiguousarray(a, np.int32))

    member = np.ascontiguousarray(member, np.uint8)
    cap = int(x_len) + int(y_len)
    col_x = np.empty(cap, np.int32)
    col_y = np.empty(cap, np.int32)
    bounds = np.zeros(4, np.int64)
    score = np.zeros(1, np.float64)
    zq = np.zeros(max(int(y_len), 1), np.int32)
    n = lib.qdp_align_viterbi_path(
        p32(x_tok), int(x_len),
        p32(y_tok), p32(y_mk), p32(y_ik_pad),
        p32(y_q if y_q is not None else zq), int(y_len), int(y_has_qual),
        int(d_lo), int(W),
        member.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        _p64(tabs["match_score"]), _p64(tabs["match_score_noq"]),
        _p64(tabs["insert_score"]), _p64(tabs["insert_score_noq"]),
        Km, Q,
        _p64(tabs["m2m"]), _p64(tabs["m2i"]), _p64(tabs["m2d"]),
        _p64(tabs["m2e"]),
        float(tables.d2d), float(tables.d2m),
        float(tables.i2i), float(tables.i2m),
        int(bool(local)),
        _p64(score), _p32(col_x), _p32(col_y),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        raise RuntimeError("Traceback error: no finite source")
    return (
        col_x[cap - n :], col_y[cap - n :],
        int(bounds[0]), int(bounds[1]), float(score[0]),
    )


def viterbi_traceback_cols(
    x_tok, x_len, y_tok, y_mk, y_ik_pad, y_q, y_len, y_has_qual,
    tables, local, d_lo, mat, ins, dele,
):
    """Native read-vs-ref traceback over filled matrices.  Returns (col_x,
    col_y, x_start, x_end) with -1 = gap.  Raises on a broken traceback
    (no finite source)."""
    lib = get_lib()
    tabs = _align_tabs(tables)
    Km, Q = tabs["match_score"].shape[1], tabs["match_score"].shape[2]

    def p32(a):
        return _p32(np.ascontiguousarray(a, np.int32))

    mat = np.ascontiguousarray(mat, dtype=np.float64)
    ins = np.ascontiguousarray(ins, dtype=np.float64)
    dele = np.ascontiguousarray(dele, dtype=np.float64)
    n_rows, W = mat.shape[0] - 1, mat.shape[1]
    cap = int(x_len) + int(y_len)
    col_x = np.empty(cap, np.int32)
    col_y = np.empty(cap, np.int32)
    bounds = np.zeros(4, np.int64)
    zq = np.zeros(max(int(y_len), 1), np.int32)
    n = lib.qdp_viterbi_traceback(
        p32(x_tok), int(x_len),
        p32(y_tok), p32(y_mk), p32(y_ik_pad),
        p32(y_q if y_q is not None else zq), int(y_len), int(y_has_qual),
        n_rows, int(d_lo), W,
        _p64(tabs["match_score"]), _p64(tabs["match_score_noq"]),
        _p64(tabs["insert_score"]), _p64(tabs["insert_score_noq"]),
        Km, Q,
        _p64(tabs["m2m"]), _p64(tabs["m2i"]), _p64(tabs["m2d"]),
        _p64(tabs["m2e"]),
        float(tables.d2d), float(tables.d2m),
        float(tables.i2i), float(tables.i2m),
        int(bool(local)),
        _p64(mat), _p64(ins), _p64(dele),
        _p32(col_x), _p32(col_y),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        raise RuntimeError("Traceback error: no finite source")
    return (
        col_x[cap - n :], col_y[cap - n :],
        int(bounds[0]), int(bounds[1]),
    )


# ---------------------------------------------------------------------------
# overlap (native/overlapdp.cpp, native/tracebackdp.cpp)


def ref_lse_chain_native(acc: np.ndarray, terms: np.ndarray) -> None:
    """The ordered truncated-lse chain in C (qref_lse_chain): acc =
    ref_lse(acc, terms[t]) for t ascending, in place.  acc must be
    contiguous float64; terms is [n_steps, *acc.shape]."""
    lib = get_lib()
    t = np.ascontiguousarray(terms, np.float64)
    lib.qref_lse_chain(_p64(acc), _p64(t), int(t.shape[0]), int(acc.size))


def _overlap_tabs(tables) -> dict:
    """Contiguous float64 table arrays for the native overlap calls, cached
    per OverlapScoreTables instance."""
    tabs = getattr(tables, "_native_tabs", None)
    if tabs is None:
        tabs = {
            k: np.ascontiguousarray(getattr(tables, k), dtype=np.float64)
            for k in ("pair_qq", "pair_xq", "pair_yq", "pair_nn",
                      "m2m", "m2i", "m2d")
        }
        tabs["trans"] = np.array(
            [tables.i2m_eff, tables.i2i_eff, tables.i2d_eff,
             tables.d2m_eff, tables.d2i_eff, tables.d2d_eff], np.float64)
        tables._native_tabs = tabs
    return tabs


def _overlap_tab_args(tables) -> list:
    """The table arguments every native overlap call ends with."""
    tabs = _overlap_tabs(tables)
    return [
        _p64(tabs["pair_qq"]), _p64(tabs["pair_xq"]),
        _p64(tabs["pair_yq"]), _p64(tabs["pair_nn"]),
        tabs["pair_qq"].shape[0], tabs["pair_qq"].shape[2],
        _p64(tabs["m2m"]), _p64(tabs["m2i"]), _p64(tabs["m2d"]),
        tabs["m2m"].shape[0], _p64(tabs["trans"]),
    ]


def _overlap_batch_call(fn, batch, tables, outputs) -> None:
    """One native overlap fill per pair of an OverlapBatch on a thread pool
    (ctypes releases the GIL); the caller's outputs(b) gives the pair's
    output pointers."""
    from concurrent.futures import ThreadPoolExecutor

    base = batch.base
    B, W = base.member.shape
    x_mk = np.ascontiguousarray(batch.x_match_kmer, np.int32)
    x_ik = np.ascontiguousarray(batch.x_indel_kmer_pad, np.int32)
    x_q = np.ascontiguousarray(batch.x_qual, np.int32)
    y_mk = np.ascontiguousarray(base.y_match_kmer, np.int32)
    y_ik = np.ascontiguousarray(base.y_indel_kmer_pad, np.int32)
    y_q = np.ascontiguousarray(base.y_qual, np.int32)
    member = np.ascontiguousarray(base.member, np.uint8)
    tab_args = _overlap_tab_args(tables)

    def run(b):
        fn(
            _p32(x_mk[b]), _p32(x_ik[b]), _p32(x_q[b]),
            int(base.x_len[b]), int(batch.x_has_qual[b]),
            _p32(y_mk[b]), _p32(y_ik[b]), _p32(y_q[b]),
            int(base.y_len[b]), int(base.y_has_qual[b]),
            0, base.max_y_len,  # every row: j_off 0
            int(base.d_lo[b]), W,
            member[b].ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            *tab_args, *outputs(b),
        )

    if B == 1:
        run(0)
    else:
        with ThreadPoolExecutor(min(B, os.cpu_count() or 1)) as ex:
            list(ex.map(run, range(B)))


def overlap_fill_native(batch, tables) -> dict:
    """Exact banded float64 overlap fill of an OverlapBatch, one C call per
    pair: {"score" [B] (end + full-sequence insert scores), "end" [B],
    "mat"/"ins"/"del" [B, R+1, W]} (row 0 the all -inf virtual row)."""
    lib = get_lib()
    B, W = batch.base.member.shape
    R = batch.base.max_y_len
    mat, ins, dele = _alloc_outputs([(B, R + 1, W)] * 3)
    end = np.empty(B, np.float64)
    _overlap_batch_call(
        lib.qdp_overlap_fill, batch, tables,
        lambda b: (_p64(mat[b]), _p64(ins[b]), _p64(dele[b]), _p64(end[b:])),
    )
    score = end + batch.x_insert_score + batch.y_insert_score
    return {"score": score, "end": end, "mat": mat, "ins": ins, "del": dele}


def overlap_score_native(batch, tables) -> np.ndarray:
    """Score-only exact overlap fills: end + full-sequence insert scores
    per pair ([B] float64), no matrices.  Same arithmetic and op order as
    overlap_fill_native, so the scores are bitwise equal."""
    lib = get_lib()
    end = np.empty(batch.base.member.shape[0], np.float64)
    _overlap_batch_call(lib.qdp_overlap_score, batch, tables,
                        lambda b: (_p64(end[b:]),))
    return end + batch.x_insert_score + batch.y_insert_score


def _qual_or_zeros(q, n) -> np.ndarray:
    """A read's quality array as contiguous int32, zeros for a read
    without qualities (the native calls read it only when has_qual)."""
    if q is None:
        return np.zeros(max(int(n), 1), np.int32)
    return np.ascontiguousarray(q, np.int32)


def overlap_strip_score_native(
    x_mk, x_ik_pad, x_q, x_len, x_has_qual,
    y_mk, y_ik_pad, y_q, y_len, y_has_qual,
    j_off, n_rows, d_lo, W, member, tables,
) -> float:
    """Score-only exact fill of ONE envelope strip from the pair's
    full-length arrays.  The y-side arrays are sliced here to the live row
    window exactly as OverlapBatch's row trimming does, so the end score is
    bitwise equal to the batched fill's.  Returns the raw end score (the
    caller adds the full-sequence insert scores)."""
    lib = get_lib()
    o, n = int(j_off), int(n_rows)
    nn = max(0, min(n, int(y_len) - o))
    ymk_s = np.zeros(n, np.int32)
    ymk_s[:nn] = y_mk[o : o + nn]
    yq_s = np.zeros(n, np.int32)
    if y_q is not None:
        yq_s[:nn] = y_q[o : o + nn]
    yik_s = np.zeros(n + 1, np.int32)
    yik_s[: nn + 1] = y_ik_pad[o : o + nn + 1]
    member = np.ascontiguousarray(member, np.uint8)
    x_mk = np.ascontiguousarray(x_mk, np.int32)
    x_ik_pad = np.ascontiguousarray(x_ik_pad, np.int32)
    end = np.zeros(1, np.float64)
    lib.qdp_overlap_score(
        _p32(x_mk), _p32(x_ik_pad), _p32(_qual_or_zeros(x_q, x_len)),
        int(x_len), int(bool(x_has_qual)),
        _p32(ymk_s), _p32(yik_s), _p32(yq_s),
        int(y_len), int(bool(y_has_qual)),
        o, n, int(d_lo), int(W),
        member.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        *_overlap_tab_args(tables), _p64(end),
    )
    return float(end[0])


def overlap_viterbi_path_cols_batch(tasks):
    """Checkpointed overlap fill + traceback of a slice of (pair, strip)
    tasks in ONE native call (qdp_overlap_viterbi_path_batch): a pool
    worker then stays in GIL-free C for the whole slice instead of
    marshalling ~30 ctypes arguments and reacquiring the GIL per task.  No
    DP matrix is kept.  Each task is the argument tuple

        (x_mk, x_ik_pad, x_q|None, x_len, x_has_qual,
         y_mk, y_ik_pad, y_q|None, y_len, y_has_qual,
         j_off, n_rows, d_lo, W, member, tables)

    with full-length y arrays, and the result is [(cols, end), ...]: cols
    is (col_x, col_y, x_start, x_end, y_start, y_end), or None when no end
    cell is finite (no alignment); end is the raw end score, bitwise equal
    to the stored fill's (the caller adds the insert scores).  Raises on a
    broken traceback."""
    lib = get_lib()
    n = len(tasks)
    if n == 0:
        return []
    xyptr = np.empty((n, 7), np.uint64)
    geom = np.empty((n, 6), np.int64)
    hasq = np.empty((n, 2), np.int32)
    tabptr = np.empty((n, 8), np.uint64)
    tabdim = np.empty((n, 3), np.int64)
    colptr = np.empty((n, 2), np.uint64)
    end = np.zeros(n, np.float64)
    bounds = np.zeros((n, 4), np.int64)
    ret = np.zeros(n, np.int64)

    keep = []  # contiguous copies must outlive the native call
    caps = np.asarray([int(t[3]) + int(t[8]) for t in tasks], np.int64)
    offs = np.concatenate([[0], np.cumsum(caps)])
    arena_x = np.empty(int(offs[-1]), np.int32)
    arena_y = np.empty(int(offs[-1]), np.int32)

    def ptr(a, dt=np.int32):
        c = np.ascontiguousarray(a, dt)
        keep.append(c)
        return c.ctypes.data

    for i, t in enumerate(tasks):
        (x_mk, x_ik_pad, x_q, x_len, x_hq,
         y_mk, y_ik_pad, y_q, y_len, y_hq,
         j_off, n_rows, d_lo, W, member, tables) = t
        tabs = _overlap_tabs(tables)
        xyptr[i] = (
            ptr(x_mk), ptr(x_ik_pad), ptr(_qual_or_zeros(x_q, x_len)),
            ptr(y_mk), ptr(y_ik_pad), ptr(_qual_or_zeros(y_q, y_len)),
            ptr(member, np.uint8),
        )
        geom[i] = (int(x_len), int(y_len), int(j_off), int(n_rows),
                   int(d_lo), int(W))
        hasq[i] = (int(bool(x_hq)), int(bool(y_hq)))
        for k, name in enumerate(("pair_qq", "pair_xq", "pair_yq", "pair_nn",
                                  "m2m", "m2i", "m2d", "trans")):
            tabptr[i, k] = tabs[name].ctypes.data
        tabdim[i] = (tabs["pair_qq"].shape[0], tabs["pair_qq"].shape[2],
                     tabs["m2m"].shape[0])
        colptr[i, 0] = arena_x.ctypes.data + int(offs[i]) * 4
        colptr[i, 1] = arena_y.ctypes.data + int(offs[i]) * 4

    u64p = ctypes.POINTER(ctypes.c_uint64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.qdp_overlap_viterbi_path_batch(
        n, xyptr.ctypes.data_as(u64p), geom.ctypes.data_as(i64p),
        _p32(hasq), tabptr.ctypes.data_as(u64p), tabdim.ctypes.data_as(i64p),
        colptr.ctypes.data_as(u64p), _p64(end), bounds.ctypes.data_as(i64p),
        ret.ctypes.data_as(i64p),
    )

    out = []
    for i in range(n):
        ni = int(ret[i])
        if ni == -2:
            out.append((None, float(end[i])))
            continue
        if ni < 0:
            raise RuntimeError("Traceback error: no finite source")
        o, cap = int(offs[i]), int(caps[i])
        out.append((
            (arena_x[o + cap - ni : o + cap], arena_y[o + cap - ni : o + cap],
             int(bounds[i, 0]), int(bounds[i, 1]),
             int(bounds[i, 2]), int(bounds[i, 3])),
            float(end[i]),
        ))
    return out


def overlap_traceback_cols(
    x_mk, x_ik_pad, x_q, x_len, x_has_qual,
    y_mk, y_ik_pad, y_q, y_len, y_has_qual,
    tables, row_off, d_lo, mat, ins, dele,
):
    """Native overlap traceback over filled matrices.  Returns (col_x,
    col_y, x_start, x_end, y_start, y_end) with -1 = gap; raises on a
    broken traceback (no finite source)."""
    lib = get_lib()
    mat = np.ascontiguousarray(mat, dtype=np.float64)
    ins = np.ascontiguousarray(ins, dtype=np.float64)
    dele = np.ascontiguousarray(dele, dtype=np.float64)
    n_rows, W = mat.shape[0] - 1, mat.shape[1]
    cap = int(x_len) + int(y_len)
    col_x = np.empty(cap, np.int32)
    col_y = np.empty(cap, np.int32)
    bounds = np.zeros(4, np.int64)

    def p32(a):
        return _p32(np.ascontiguousarray(a, np.int32))

    n = lib.qdp_overlap_traceback(
        p32(x_mk), p32(x_ik_pad), _p32(_qual_or_zeros(x_q, x_len)),
        int(x_len), int(x_has_qual),
        p32(y_mk), p32(y_ik_pad), _p32(_qual_or_zeros(y_q, y_len)),
        int(y_len), int(y_has_qual),
        int(row_off), n_rows, int(d_lo), W,
        *_overlap_tab_args(tables),
        _p64(mat), _p64(ins), _p64(dele),
        _p32(col_x), _p32(col_y),
        bounds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if n < 0:
        raise RuntimeError("Overlap traceback error: no finite source")
    return (
        col_x[cap - n :], col_y[cap - n :],
        int(bounds[0]), int(bounds[1]), int(bounds[2]), int(bounds[3]),
    )


def diag_kmer_index_native(y_tok: np.ndarray, k: int):
    """Reusable counting-bucket k-mer index of y (k <= 12): (bucket_count
    [4^k+1] int32, y_pos [ny] int32), or None for longer k."""
    if k > 12:
        return None
    lib = get_lib()
    y = np.ascontiguousarray(y_tok, dtype=np.int32)
    ny = max(len(y) - k + 1, 0)
    bucket_count = np.empty((1 << (2 * k)) + 1, np.int32)
    y_pos = np.empty(max(ny, 1), np.int32)
    lib.qio_diag_kmer_index(_p32(y), len(y), k, _p32(bucket_count),
                            _p32(y_pos))
    return bucket_count, y_pos


def diag_kmer_counts_indexed_native(
    x_tok: np.ndarray, y_len: int, k: int, index
) -> Tuple[np.ndarray, np.ndarray]:
    """Join x against a prebuilt diag_kmer_index_native index."""
    lib = get_lib()
    bucket_count, y_pos = index
    x = np.ascontiguousarray(x_tok, dtype=np.int32)
    cap = len(x) + int(y_len) + 2
    diags = np.empty(cap, dtype=np.int64)
    counts = np.empty(cap, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.qio_diag_kmer_counts_indexed(
        _p32(x), len(x), int(y_len), k, _p32(bucket_count), _p32(y_pos),
        diags.ctypes.data_as(i64p), counts.ctypes.data_as(i64p),
    )
    return diags[:n].copy(), counts[:n].copy()


def diag_kmer_counts_native(
    x_tok: np.ndarray, y_tok: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    lib = get_lib()
    x = np.ascontiguousarray(x_tok, dtype=np.int32)
    y = np.ascontiguousarray(y_tok, dtype=np.int32)
    cap = len(x) + len(y) + 2
    diags = np.empty(cap, dtype=np.int64)
    counts = np.empty(cap, dtype=np.int64)
    i64p = ctypes.POINTER(ctypes.c_int64)
    n = lib.qio_diag_kmer_counts(
        _p32(x), len(x), _p32(y), len(y), k,
        diags.ctypes.data_as(i64p), counts.ctypes.data_as(i64p),
    )
    return diags[:n].copy(), counts[:n].copy()
