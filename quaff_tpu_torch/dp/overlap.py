"""Read-vs-read overlap model: the derived pair-emission tables.

Ported from quaff_tpu/dp/overlap.py (OverlapScoreTables and its truncated
log-sum-exp).  The tables reimplement the reference's QuaffOverlapScores
(src/qoverlap.cpp:9-160): the overlap model marginalises the unknown
reference out of two read-generating transducers,

  matchMinusInsert[i_kmer, j_kmer, qi, qj] =
      log sum_r refBase[r] * match(r -> i, qi) * match(r* -> j, qj)
      - insert(i, qi) - insert(j, qj)

(r* is the complement when the second read is a reverse-strand copy), and
approximates the transducer-intersection gap structure with averaged
gap-open/extend/adjacent probabilities (qoverlap.cpp:22-48).  The tables
are built once per (params, strand), in float64 numpy, bitwise equal to
the JAX package's.

NOTE on gap scores: the reference's accessor layer swaps i2m<->i2i and
d2m<->d2i relative to the constructor's fields (qoverlap.h:46-51).  The
*effective* values those accessors produce are what its golden outputs
encode, so the effective values are stored directly:
  i2m_eff = d2d_eff = log(gapExtend)
  i2i_eff = d2i_eff = log(1-gapExtend) + log(1-gapAdjacent)
  i2d_eff = log(1-gapExtend) + log(gapAdjacent)
  d2m_eff = log(1-gapExtend) + log(gapAdjacent)

The float64 banded fill of these tables is the host library's
(native/overlapdp.cpp, bound in native.py), for every route of the port;
the JAX package's XLA fill (overlap_fill) and its device tables are not
ported.  The float32 score fill on the device is K4 (dp/ov_fill.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..alphabet import ALPHABET_SIZE, QUAL_SCORE_RANGE
from ..model.params import QuaffParams
from .scores import ScoreTables


@dataclass
class OverlapScoreTables:
    match_kmer_len: int
    indel_kmer_len: int
    y_complemented: bool
    # emissions (log): pair tables conditioned on available quality scores
    pair_qq: np.ndarray  # [Km, Km, Q, Q]
    pair_xq: np.ndarray  # [Km, Km, Q]
    pair_yq: np.ndarray  # [Km, Km, Q]
    pair_nn: np.ndarray  # [Km, Km]
    insert_score: np.ndarray  # [4, Q]  (x and y share the insert model)
    insert_score_noq: np.ndarray  # [4]
    # transitions (log, effective values; see module docstring)
    m2m: np.ndarray  # [Ki, Ki]
    m2i: np.ndarray  # [Ki, Ki]
    m2d: np.ndarray  # [Ki, Ki]
    i2m_eff: float
    i2i_eff: float
    i2d_eff: float
    d2m_eff: float
    d2i_eff: float
    d2d_eff: float

    @classmethod
    def from_params(
        cls, qp: QuaffParams, y_complemented: bool, tables: ScoreTables | None = None
    ) -> "OverlapScoreTables":
        if tables is None:
            tables = ScoreTables.from_params(qp)
        ki = qp.num_indel_kmers
        km = qp.num_match_kmers

        # gap structure (qoverlap.cpp:22-48)
        ri = qp.begin_insert
        rd = (1 - qp.begin_insert) * qp.begin_delete
        gap_open = ri + rd  # [Ki]
        p_gap_is_insert = ri / gap_open
        gap_adjacent_k = p_gap_is_insert * ri + (1 - p_gap_is_insert) * gap_open / (
            1 - qp.extend_delete * (1 - gap_open)
        )
        m2m = np.log(1 - gap_open)[:, None] + np.log(1 - gap_open)[None, :]
        m2i = np.broadcast_to(np.log(gap_open)[:, None], (ki, ki)).copy()
        m2d = np.log(1 - gap_open)[:, None] + np.log(gap_open)[None, :]

        pgi = float(np.mean(p_gap_is_insert))
        mean_gap_len = pgi / qp.extend_insert + (1 - pgi) / qp.extend_delete
        gap_extend = 1.0 / mean_gap_len
        gap_adjacent = float(np.mean(gap_adjacent_k))

        log_ge = np.log(gap_extend)
        log_1ge = np.log(1 - gap_extend)
        log_ga = np.log(gap_adjacent)
        log_1ga = np.log(1 - gap_adjacent)

        # pair emission tables (qoverlap.cpp:53-74), vectorised over
        # (kmer_i, kmer_j, qi, qj) with the reference marginalised out.
        # The log-sum-exp here reproduces the reference's lookup-table
        # semantics (logsumexp.cpp:84-103): contributions more than 10 nats
        # below the running max are dropped.  Golden overlap scores encode
        # that truncation (~2.5e-6/column), so exact lse would drift by
        # ~0.02 over a 6.6kb alignment.
        ms = tables.match_score  # [4, Km, Q]
        log_rb = np.log(qp.ref_base)  # [4]
        r_idx = np.arange(ALPHABET_SIZE)
        y_r = (ALPHABET_SIZE - 1 - r_idx) if y_complemented else r_idx
        # sequential truncated lse over r, in the reference's order
        m_pair = np.full((km, km, QUAL_SCORE_RANGE, QUAL_SCORE_RANGE), -np.inf)
        for r in range(ALPHABET_SIZE):
            term = (
                log_rb[r]
                + ms[r][:, None, :, None]
                + ms[y_r[r]][None, :, None, :]
            )
            m_pair = _ref_lse(m_pair, term)

        ins = tables.insert_score  # [4, Q]
        ins_n = tables.insert_score_noq  # [4]
        i_sfx = np.arange(km) % ALPHABET_SIZE
        xi = ins[i_sfx]  # [Km, Q]
        xn = ins_n[i_sfx]  # [Km]

        pair_qq = (
            m_pair - xi[:, None, :, None] - xi[None, :, None, :]
        )
        # marginal tables: the reference accumulates these with sequential
        # truncated lse in (qi outer, qj inner) order (qoverlap.cpp:59-71).
        # Each output slot's accumulation order is preserved exactly; the
        # independent slots are batched per step, and the whole ordered
        # chain runs in C (thousands of tiny numpy dispatches otherwise).
        Q = QUAL_SCORE_RANGE
        # XQual[ik]: per slot ik, sequential over jk
        t_xq = np.ascontiguousarray(
            (m_pair - xi[:, None, :, None] - xn[None, :, None, None])
            .transpose(3, 0, 1, 2)  # [jk, km, km, ik]
        )
        pair_xq = _ref_lse_chain(np.full((km, km, Q), -np.inf), t_xq)
        # YQual[jk]: per slot jk, sequential over ik
        t_yq = np.ascontiguousarray(
            (m_pair - xn[:, None, None, None] - xi[None, :, None, :])
            .transpose(2, 0, 1, 3)  # [ik, km, km, jk]
        )
        pair_yq = _ref_lse_chain(np.full((km, km, Q), -np.inf), t_yq)
        # PairProb: one slot, sequential over (ik, jk) lexicographic
        t_nn = np.ascontiguousarray(
            (m_pair - xn[:, None, None, None] - xn[None, :, None, None])
            .transpose(2, 3, 0, 1)  # [ik, jk, km, km]
            .reshape(Q * Q, km, km)
        )
        pair_nn = _ref_lse_chain(np.full((km, km), -np.inf), t_nn)

        out = cls(
            match_kmer_len=qp.match_kmer_len,
            indel_kmer_len=qp.indel_kmer_len,
            y_complemented=y_complemented,
            pair_qq=pair_qq,
            pair_xq=pair_xq,
            pair_yq=pair_yq,
            pair_nn=pair_nn,
            insert_score=tables.insert_score,
            insert_score_noq=tables.insert_score_noq,
            m2m=m2m,
            m2i=m2i,
            m2d=m2d,
            i2m_eff=float(log_ge),
            i2i_eff=float(log_1ge + log_1ga),
            i2d_eff=float(log_1ge + log_ga),
            d2m_eff=float(log_1ge + log_ga),
            d2i_eff=float(log_1ge + log_1ga),
            d2d_eff=float(log_ge),
        )
        # extras consumed by K4 (dp/ov_fill.py), which recomputes each
        # cell's pair emission from the base tables
        out.base_tables = tables
        out.log_ref_base = np.log(qp.ref_base)
        # per-indel-kmer gap-open logs: K4 rebuilds m2m/m2i/m2d per cell
        # from their separable form (qoverlap.cpp:35-39)
        #   m2m[i][j] = stay[i] + stay[j]; m2i[i][j] = open[i];
        #   m2d[i][j] = stay[i] + open[j]
        out.log_gap_open = np.log(gap_open)
        out.log_gap_stay = np.log(1 - gap_open)
        r_ids = np.arange(ALPHABET_SIZE)
        out.y_symbol_map = (
            (ALPHABET_SIZE - 1 - r_ids) if y_complemented else r_ids
        )
        return out


def _ref_lse_chain(acc: np.ndarray, terms: np.ndarray) -> np.ndarray:
    """Ordered _ref_lse accumulation, acc = ref_lse(acc, terms[t]) for t
    ascending, in C (native/quaffio.cpp qref_lse_chain: the same float ops
    as _ref_lse, bit for bit).  terms is [n_steps, *acc.shape]."""
    from ..native import ref_lse_chain_native

    acc = np.ascontiguousarray(acc, np.float64)
    ref_lse_chain_native(acc, terms)
    return acc


def _ref_lse(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The reference's lookup-table log-sum-exp semantics
    (logsumexp.cpp:34-103): exact log1p(exp(-diff)) correction for
    diff < 10, but contributions >= 10 nats below the max are DROPPED
    (the table covers [0, 10) only and returns 0 beyond it).  Golden
    overlap scores depend on this truncation."""
    m = np.maximum(a, b)
    with np.errstate(invalid="ignore"):
        d = np.abs(a - b)
        corr = np.log1p(np.exp(-np.minimum(d, 50.0)))
    out = np.where((d >= 10.0) | ~np.isfinite(d), m, m + corr)
    return np.where(np.isneginf(a) & np.isneginf(b), a, out)
