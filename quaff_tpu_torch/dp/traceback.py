"""Host-side Viterbi traceback over filled banded DP matrices (jax-free
copy of quaff_tpu/dp/traceback.py, whose package __init__ imports JAX).

The fill (native f64, or dp/engine.py) comes first; the traceback walks the filled
band on the host in numpy, replicating the reference's traceback exactly —
including its tie-breaking preference order Match > Insert > Delete > Start
via strict-greater updates (QuaffViterbiMatrix::alignment,
src/qmodel.cpp:1562-1646) — so alignments are identical in float64.
Path length is O(xLen + yLen), negligible next to the fill.
"""

from __future__ import annotations

import math

import numpy as np

from quaff_tpu.envelope import Envelope
from quaff_tpu.formats.alignment import GAP_CHAR, Alignment
from quaff_tpu.io.fastseq import FastSeq, SeqIntervalCoords
from .scores import ScoreTables

NEG_INF = -math.inf

MATCH, INSERT, DELETE, START = 0, 1, 2, 3


def _cols_to_str(cols: np.ndarray, seq: str, gap: str) -> str:
    """Per-column characters from 0-based index columns (-1 = gap)."""
    chars = np.frombuffer(seq.encode("latin-1"), np.uint8)
    out = np.where(
        cols >= 0, chars[np.clip(cols, 0, None)], np.uint8(ord(gap))
    ).astype(np.uint8)
    return out.tobytes().decode("latin-1")


class _Cells:
    def __init__(self, arr: np.ndarray, env: Envelope):
        self.arr = arr
        self.d_lo = env.band_lo
        self.w = env.band_width
        self.x_len = env.x_len
        self.y_len = env.y_len

    def __call__(self, i: int, j: int) -> float:
        if j < 0 or j > self.y_len or i < 0 or i > self.x_len:
            return NEG_INF
        w = i - j - self.d_lo
        if w < 0 or w >= self.w:
            return NEG_INF
        return float(self.arr[j, w])


def _cols_to_alignment(x, y, col_x, col_y, x_start, x_end, score, local,
                       has_qual):
    ref_row = FastSeq(name="Ref")
    read_row = FastSeq(name="Read")
    if local:
        ref_row.comment = f"substr({x.name},{x_start}..{x_end})"
    else:
        ref_row.comment = x.name
    read_row.comment = y.name
    ref_row.seq = _cols_to_str(col_x, x.seq, GAP_CHAR)
    read_row.seq = _cols_to_str(col_y, y.seq, GAP_CHAR)
    if has_qual:
        read_row.qual = _cols_to_str(col_y, y.qual, "~")
    ref_row.source = SeqIntervalCoords(
        x.name, x_start, x_end, False
    ).compose(x.source)
    read_row.source = SeqIntervalCoords(
        y.name, 1, len(y.seq), False
    ).compose(y.source)
    return Alignment(gapped_seq=[ref_row, read_row], score=score)


def viterbi_path_traceback(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    tables: ScoreTables,
    local: bool = True,
):
    """Fill AND walk one (pair, strip) in a single checkpointed native
    call — no DP matrices materialise (native qdp_align_viterbi_path;
    cells the walk reads are bitwise equal to the full fill's).  The
    returned Alignment's score is the raw end score (caller subtracts
    the null model).  None when the native library is missing."""
    from quaff_tpu.native import align_viterbi_path_cols

    x_len, y_len = len(x.seq), len(y.seq)
    has_qual = y.has_qual()
    y_ik = np.concatenate([[0], y.kmers(tables.indel_kmer_len)])
    res = align_viterbi_path_cols(
        x.tokens(), x_len, y.tokens(), y.kmers(tables.match_kmer_len),
        y_ik, y.qual_scores() if has_qual else None, y_len, has_qual,
        tables, local, env.band_lo, env.band_width, env.member_mask(),
    )
    if res is None:
        return None
    col_x, col_y, x_start, x_end, score = res
    return _cols_to_alignment(
        x, y, col_x, col_y, x_start, x_end, score, local, has_qual
    )


def viterbi_traceback(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    tables: ScoreTables,
    mat: np.ndarray,
    ins: np.ndarray,
    dele: np.ndarray,
    result: float,
    local: bool = True,
    check: bool = False,
) -> Alignment:
    """Walk the filled band back from the best end cell to Start."""
    x_len, y_len = len(x.seq), len(y.seq)
    x_tok = x.tokens()
    y_km = y.kmers(tables.match_kmer_len)
    y_ik = np.concatenate([[0], y.kmers(tables.indel_kmer_len)])  # padded
    has_qual = y.has_qual()
    y_q = y.qual_scores() if has_qual else None

    if not check:
        from quaff_tpu.native import viterbi_traceback_cols

        cols = viterbi_traceback_cols(
            x_tok, x_len, y.tokens(), y_km, y_ik, y_q, y_len, has_qual,
            tables, local, env.band_lo, mat, ins, dele,
        )
        if cols is not None:
            col_x, col_y, x_start, x_end = cols
            return _cols_to_alignment(
                x, y, col_x, col_y, x_start, x_end, result, local, has_qual
            )

    m = _Cells(mat, env)
    i_ = _Cells(ins, env)
    d_ = _Cells(dele, env)

    def match_emit(i: int, j: int) -> float:
        if has_qual:
            return float(tables.match_score[x_tok[i - 1], y_km[j - 1], y_q[j - 1]])
        return float(tables.match_score_noq[x_tok[i - 1], y_km[j - 1]])

    y_tok = y.tokens()

    def insert_emit(j: int) -> float:
        if has_qual:
            return float(tables.insert_score[y_tok[j - 1], y_q[j - 1]])
        return float(tables.insert_score_noq[y_tok[j - 1]])

    def m2m(j):
        return float(tables.m2m[y_ik[j]])

    def m2i(j):
        return float(tables.m2i[y_ik[j]])

    def m2d(j):
        return float(tables.m2d[y_ik[j]])

    def m2e(j):
        return float(tables.m2e[y_ik[j]])

    # choose the end column (highest i achieving the max, local mode;
    # qmodel.cpp:1564-1575)
    x_end = x_len
    if local:
        best = NEG_INF
        for i_end in range(x_len, 0, -1):
            sc = m(i_end, y_len) + m2e(y_len)
            if i_end == x_len or sc > best:
                best = sc
                x_end = i_end

    i, j = x_end, y_len
    x_row: list = []
    y_row: list = []
    y_qual_row: list = []
    state = MATCH

    while state != START:
        src = NEG_INF
        if state == MATCH:
            emit = match_emit(i, j)
            i -= 1
            j -= 1
            x_row.append(x.seq[i])
            y_row.append(y.seq[j])
            if has_qual:
                y_qual_row.append(y.qual[j])
            cands = [
                (m(i, j) + m2m(j) + emit, MATCH),
                (i_(i, j) + tables.i2m + emit, INSERT),
                (d_(i, j) + tables.d2m + emit, DELETE),
            ]
            if j == 0 and (i == 0 or local):
                cands.append((emit, START))
            expect = m(i + 1, j + 1)
        elif state == INSERT:
            emit = insert_emit(j)
            j -= 1
            x_row.append(GAP_CHAR)
            y_row.append(y.seq[j])
            if has_qual:
                y_qual_row.append(y.qual[j])
            cands = [
                (m(i, j) + m2i(j) + emit, MATCH),
                (i_(i, j) + tables.i2i + emit, INSERT),
            ]
            expect = i_(i, j + 1)
        else:  # DELETE
            i -= 1
            x_row.append(x.seq[i])
            y_row.append(GAP_CHAR)
            if has_qual:
                y_qual_row.append("~")
            cands = [
                (m(i, j) + m2d(j), MATCH),
                (d_(i, j) + tables.d2d, DELETE),
            ]
            expect = d_(i + 1, j)
        # strict-greater argmax in candidate order (updateMax semantics)
        src, state = NEG_INF, None
        for sc, st in cands:
            if sc > src:
                src, state = sc, st
        if state is None:
            raise RuntimeError("Traceback error: no finite source")
        if check and not math.isclose(src, expect, rel_tol=1e-9, abs_tol=1e-6):
            raise RuntimeError(
                f"Traceback check failed at i={i} j={j}: {src} != {expect}"
            )

    x_start = i + 1
    ref_row = FastSeq(name="Ref")
    read_row = FastSeq(name="Read")
    if local:
        ref_row.comment = f"substr({x.name},{x_start}..{x_end})"
    else:
        ref_row.comment = x.name
    read_row.comment = y.name
    ref_row.seq = "".join(reversed(x_row))
    read_row.seq = "".join(reversed(y_row))
    read_row.qual = "".join(reversed(y_qual_row))
    ref_row.source = SeqIntervalCoords(x.name, x_start, x_end, False).compose(x.source)
    read_row.source = SeqIntervalCoords(y.name, 1, y_len, False).compose(y.source)
    align = Alignment(gapped_seq=[ref_row, read_row], score=result)
    return align
