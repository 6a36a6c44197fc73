"""Host-side Viterbi traceback of read-vs-ref alignments (the port's
counterpart of quaff_tpu/dp/traceback.py, whose package __init__ imports
JAX).

Both walks run in the port's native library: over matrices a float64 fill
has produced (viterbi_traceback), or fused with a checkpointed fill that
keeps no matrices (viterbi_path_traceback).  The walk replicates the
reference's traceback exactly, including its tie-breaking preference
order Match > Insert > Delete > Start via strict-greater updates
(QuaffViterbiMatrix::alignment, src/qmodel.cpp:1562-1646), so alignments
are identical in float64.
"""

from __future__ import annotations

import numpy as np

from ..envelope import Envelope
from ..formats.alignment import GAP_CHAR, Alignment
from ..io.fastseq import FastSeq, SeqIntervalCoords
from .scores import ScoreTables


def _cols_to_str(cols: np.ndarray, seq: str, gap: str) -> str:
    """Per-column characters from 0-based index columns (-1 = gap)."""
    chars = np.frombuffer(seq.encode("latin-1"), np.uint8)
    out = np.where(
        cols >= 0, chars[np.clip(cols, 0, None)], np.uint8(ord(gap))
    ).astype(np.uint8)
    return out.tobytes().decode("latin-1")


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
    the null model)."""
    from ..native import align_viterbi_path_cols

    x_len, y_len = len(x.seq), len(y.seq)
    has_qual = y.has_qual()
    y_ik = np.concatenate([[0], y.kmers(tables.indel_kmer_len)])
    col_x, col_y, x_start, x_end, score = align_viterbi_path_cols(
        x.tokens(), x_len, y.tokens(), y.kmers(tables.match_kmer_len),
        y_ik, y.qual_scores() if has_qual else None, y_len, has_qual,
        tables, local, env.band_lo, env.band_width, env.member_mask(),
    )
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
) -> Alignment:
    """Walk the filled band back from the best end cell to Start."""
    from ..native import viterbi_traceback_cols

    has_qual = y.has_qual()
    col_x, col_y, x_start, x_end = viterbi_traceback_cols(
        x.tokens(), len(x.seq), y.tokens(), y.kmers(tables.match_kmer_len),
        np.concatenate([[0], y.kmers(tables.indel_kmer_len)]),
        y.qual_scores() if has_qual else None, len(y.seq), has_qual,
        tables, local, env.band_lo, mat, ins, dele,
    )
    return _cols_to_alignment(
        x, y, col_x, col_y, x_start, x_end, result, local, has_qual
    )
