"""DP matrix debug dumps (jax-free copy of quaff_tpu/dp/debug.py).

`-log dpmatrix` reproduces QuaffDPMatrix::write (qmodel.cpp:1325-1336):
one line per in-envelope cell with the x/y symbols (and quality char) and
the mat/ins/del values, a blank line between rows, and the end score.
The reference dumps every matrix it builds; the score kernel never
materialises matrices, so dumps appear for the fills that do build them:
the exact float64 traceback fill of the alignment winner.

`-log postmatrix` dumps the posterior state probabilities of the counting
E-step's exact engine (dp/counts.py) in the same cell layout.
"""

from __future__ import annotations

import sys

import numpy as np

from ..envelope import Envelope
from ..io.fastseq import FastSeq


def _fmt(v: float) -> str:
    # C++ ostream default formatting for double (6 significant digits;
    # infinities print as inf/-inf)
    return f"{float(v):.6g}"


def write_dp_matrix(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    mat: np.ndarray,
    ins: np.ndarray,
    dele: np.ndarray,
    result: float,
    out=None,
) -> None:
    """mat/ins/del are band-coordinate arrays [Ly+1, W] with lane
    w = i - j - band_lo (the device fill's storage layout)."""
    out = out or sys.stderr
    d_lo = env.band_lo
    has_qual = y.has_qual()
    for j in range(1, env.y_len + 1):
        for i in np.asarray(env.forward_i(j)):
            w = int(i) - j - d_lo
            if w < 0 or w >= env.band_width:
                continue
            yq = y.qual[j - 1] if has_qual else ""
            out.write(
                f"i={i}:{x.seq[i - 1]} j={j}:{y.seq[j - 1]}{yq}"
                f"\tmat {_fmt(mat[j, w])}"
                f"\tins {_fmt(ins[j, w])}"
                f"\tdel {_fmt(dele[j, w])}\n"
            )
        out.write("\n")
    out.write(f"result {_fmt(result)}\n")


def write_post_matrix(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    post_mat: np.ndarray,
    post_ins: np.ndarray,
    post_del: np.ndarray,
    out=None,
) -> None:
    """`-log postmatrix` posterior-probability dump
    (QuaffForwardBackwardMatrix::write, qmodel.cpp:1790-1798; the class
    is never constructed by any reference workload, so the tag is dead
    code there — here it fires in the counting E-step, where the
    posteriors actually exist).  post_* are [Ly, W] with row j at index
    j-1; no trailing result line."""
    out = out or sys.stderr
    d_lo = env.band_lo
    has_qual = y.has_qual()
    for j in range(1, env.y_len + 1):
        for i in np.asarray(env.forward_i(j)):
            w = int(i) - j - d_lo
            if w < 0 or w >= env.band_width:
                continue
            yq = y.qual[j - 1] if has_qual else ""
            out.write(
                f"i={i}:{x.seq[i - 1]} j={j}:{y.seq[j - 1]}{yq}"
                f"\tmat {_fmt(post_mat[j - 1, w])}"
                f"\tins {_fmt(post_ins[j - 1, w])}"
                f"\tdel {_fmt(post_del[j - 1, w])}\n"
            )
        out.write("\n")
