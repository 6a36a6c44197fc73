"""Diagonal envelope: k-mer seeded banded DP domain.

Reimplements the reference's DiagonalEnvelope (src/diagenv.{h,cpp}) with
vectorised numpy: per-diagonal k-mer match counting via a sorted-array join
(instead of per-k-mer hash walks), the same seed-threshold / memory-budget
selection logic (diagenv.cpp:20-106), band dilation, the always-included
zeroth diagonal, and the storage halo.  In addition to the reference's
sparse-diagonal view it exposes a dense band view (contiguous diagonal
range + membership mask) which is what the TPU DP kernels consume: the DP
state for row j is a vector over the diagonal range, out-of-envelope lanes
pinned to -inf.

Conventions: diagonal d = i - j for 1-based DP coordinates (equivalently
0-based sequence offsets).  Member diagonals span [1-yLen, xLen-1].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .alphabet import kmer_codes
from .io.fastseq import FastSeq, KmerIndex

# defaults from the reference (diagenv.h:10-18, t/quaff.cpp:15)
DEFAULT_KMER_LENGTH = 6
DEFAULT_KMER_THRESHOLD = 14  # overlap mode
DEFAULT_REFSEQ_KMER_THRESHOLD = 20  # align / train modes
DEFAULT_BAND_SIZE = 64

# minimum sequenceLength/(kmerLen+threshold) ratio for a sparse envelope
# (diagenv.cpp:8-9)
MIN_KMERS_FOR_SPARSE_ENVELOPE = 2


@dataclass
class Envelope:
    x_len: int
    y_len: int
    diagonals: np.ndarray  # sorted member diagonals

    # -- reference-equivalent views --------------------------------------

    @property
    def storage_diagonals(self) -> np.ndarray:
        """Member diagonals dilated by the +/-1 halo (diagenv.cpp:108-115)."""
        d = self.diagonals
        return np.unique(np.concatenate([d - 1, d, d + 1]))

    @property
    def total_storage_size(self) -> int:
        """Number of stored cells: sum over rows j=0..yLen of storage
        diagonals intersecting the row with 0 <= i <= xLen
        (diagenv.cpp:116-131)."""
        sd = self.storage_diagonals
        total = 0
        for j in range(self.y_len + 1):
            total += int(np.sum((sd + j >= 0) & (sd + j <= self.x_len)))
        return total

    def contains(self, i: int, j: int) -> bool:
        d = i - j
        k = np.searchsorted(self.diagonals, d)
        return k < len(self.diagonals) and self.diagonals[k] == d

    def forward_i(self, j: int) -> np.ndarray:
        """In-envelope i values for row j, ascending (1 <= i <= xLen)."""
        i = self.diagonals + j
        return i[(i >= 1) & (i <= self.x_len)]

    # -- dense band view for the DP kernels ------------------------------

    @property
    def band_lo(self) -> int:
        """Lowest diagonal of the dense band, including the -1 halo."""
        return int(self.diagonals[0]) - 1

    @property
    def band_width(self) -> int:
        """Width of the dense band, including both halo diagonals."""
        return int(self.diagonals[-1]) - int(self.diagonals[0]) + 3

    def member_mask(self) -> np.ndarray:
        """Bool [band_width]: which lanes of the dense band are member
        diagonals (non-members are halo/gap lanes pinned to -inf in DP)."""
        mask = np.zeros(self.band_width, dtype=bool)
        mask[self.diagonals - self.band_lo] = True
        return mask

    def strips(self) -> list:
        """Decompose into sub-envelopes, one per maximal run of consecutive
        member diagonals.

        Strips are INDEPENDENT DP subproblems: every DP move (M: same
        diagonal, I: -1, D: +1, qmodel.cpp:1343-1391) steps between
        adjacent diagonals, and cells on non-member diagonals are -inf, so
        no path crosses the >=1-diagonal gap between runs.  The pair score
        is the max (Viterbi) / log-sum-exp (Forward) of the strip scores,
        and strip posteriors partition the pair posterior.  Evaluating
        strips as separate batch rows avoids filling the gap lanes of the
        bounding band (the reference's ragged storage never stores them,
        diagenv.cpp:108-133)."""
        d = self.diagonals
        breaks = np.nonzero(np.diff(d) != 1)[0] + 1
        return [
            Envelope(x_len=self.x_len, y_len=self.y_len, diagonals=run)
            for run in np.split(d, breaks)
        ]

    @property
    def num_cells(self) -> int:
        """Number of member cells in rows 1..yLen (DP work measure)."""
        d = self.diagonals
        lo = np.maximum(1 - d, 1)
        hi = np.minimum(self.x_len - d, self.y_len)
        return int(np.sum(np.maximum(hi - lo + 1, 0)))


def pack_strips(env: Envelope, max_segs: int = 3) -> list:
    """Strips merged down to at most max_segs segments (smallest-gap
    neighbours first).  A merged segment keeps the gap diagonals as
    non-member lanes, so it is always correct — just wider."""
    strips = env.strips()
    while len(strips) > max_segs:
        gaps = [
            int(strips[i + 1].diagonals[0] - strips[i].diagonals[-1])
            for i in range(len(strips) - 1)
        ]
        i = int(np.argmin(gaps))
        merged = Envelope(
            x_len=env.x_len,
            y_len=env.y_len,
            diagonals=np.concatenate(
                [strips[i].diagonals, strips[i + 1].diagonals]
            ),
        )
        strips[i : i + 2] = [merged]
    return strips


def full_envelope(x_len: int, y_len: int) -> Envelope:
    """All diagonals (diagenv.cpp:11-18)."""
    return Envelope(
        x_len=x_len,
        y_len=y_len,
        diagonals=np.arange(1 - y_len, x_len, dtype=np.int64),
    )


def diagonal_kmer_counts(
    x_tokens: np.ndarray, y_index: KmerIndex, x_len: int, y_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Count k-mer matches per diagonal (diagenv.cpp:34-40), vectorised.

    Returns (diags, counts): the diagonals with at least one match and
    their match counts.
    """
    k = y_index.kmer_len
    if k < 32:
        from .native import (
            diag_kmer_counts_indexed_native,
            diag_kmer_counts_native,
        )

        idx = y_index.native_index() if k <= 12 else None
        if idx is not None:
            res = diag_kmer_counts_indexed_native(
                x_tokens, len(y_index.seq.seq), k, idx
            )
            if res is not None:
                return res
        res = diag_kmer_counts_native(x_tokens, y_index.seq.tokens(), k)
        if res is not None:
            return res
    x_codes = kmer_codes(x_tokens, k)
    if len(x_codes) == 0 or len(y_index.sorted_codes) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    lo = np.searchsorted(y_index.sorted_codes, x_codes, "left")
    hi = np.searchsorted(y_index.sorted_codes, x_codes, "right")
    n_hits = hi - lo
    total = int(n_hits.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    # expand (i, y-hit-range) pairs into flat diagonal list
    i_rep = np.repeat(np.arange(len(x_codes), dtype=np.int64), n_hits)
    # offsets within each hit range
    starts = np.repeat(lo, n_hits)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        np.cumsum(n_hits) - n_hits, n_hits
    )
    j_hit = y_index.sorted_positions[starts + within]
    diag = i_rep - j_hit
    diags, counts = np.unique(diag, return_counts=True)
    return diags, counts


def sparse_envelope(
    x: FastSeq,
    y_index: KmerIndex,
    band_size: int = DEFAULT_BAND_SIZE,
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD,
    cell_size: int = 8,
    max_size: int = 0,
) -> Envelope:
    """Seed-threshold / memory-budget banded envelope (diagenv.cpp:20-106).

    kmer_threshold >= 0 selects diagonals with at least that many k-mer
    matches; kmer_threshold < 0 walks count levels downward and picks the
    largest threshold whose storage footprint fits max_size bytes, where
    each storage diagonal costs min(xLen,yLen)*cell_size bytes.
    """
    x_len, y_len = len(x.seq), len(y_index.seq.seq)
    kmer_len = y_index.kmer_len

    if kmer_threshold >= 0:
        min_len = MIN_KMERS_FOR_SPARSE_ENVELOPE * (kmer_len + kmer_threshold)
        if x_len < min_len or y_len < min_len:
            return full_envelope(x_len, y_len)

    diags_arr, counts_arr = diagonal_kmer_counts(x.tokens(), y_index, x_len, y_len)

    min_diag = 1 - y_len
    max_diag = x_len - 1
    half_band = band_size // 2
    diag_size = min(x_len, y_len) * cell_size

    # the zeroth diagonal is always included so at least one path exists
    # (diagenv.cpp:52-54); the walk's storage estimate starts from {0} too
    member = {0}
    storage = {0}

    # group seed diagonals by match count, walk counts descending
    order = np.argsort(counts_arr)[::-1]
    levels: list[tuple[int, np.ndarray]] = []
    if len(order):
        sorted_counts = counts_arr[order]
        sorted_diags = diags_arr[order]
        boundaries = np.nonzero(np.diff(sorted_counts))[0] + 1
        split_points = np.concatenate([[0], boundaries, [len(sorted_counts)]])
        for a, b in zip(split_points[:-1], split_points[1:]):
            levels.append((int(sorted_counts[a]), sorted_diags[a:b]))

    threshold_found = kmer_threshold >= 0
    for count, seed_diags in levels:
        if kmer_threshold >= 0 and count < kmer_threshold:
            break
        more_member = set(member)
        more_storage = set(storage)
        for seed in seed_diags:
            d_min = max(min_diag, int(seed) - half_band)
            d_max = min(max_diag, int(seed) + half_band)
            more_member.update(range(d_min, d_max + 1))
            more_storage.update(range(d_min - 1, d_max + 2))
        if kmer_threshold < 0:
            if len(more_storage) * diag_size >= max_size:
                break
            threshold_found = True
        member = more_member
        storage = more_storage

    return Envelope(
        x_len=x_len,
        y_len=y_len,
        diagonals=np.array(sorted(member), dtype=np.int64),
    )


def make_envelope(
    x: FastSeq,
    y_index: KmerIndex,
    sparse: bool = True,
    band_size: int = DEFAULT_BAND_SIZE,
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD,
    cell_size: int = 8,
    max_size: int = 0,
) -> Envelope:
    """Equivalent of QuaffDPConfig::makeEnvelope (qmodel.cpp:1045-1056)."""
    if sparse:
        return sparse_envelope(x, y_index, band_size, kmer_threshold, cell_size, max_size)
    return full_envelope(len(x.seq), len(y_index.seq.seq))


def fit_envelope_lanes(
    x: FastSeq,
    y_index: KmerIndex,
    max_lanes: int,
    band_size: int = DEFAULT_BAND_SIZE,
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD,
    max_segs: int = 3,
) -> Envelope:
    """Memory-fitted banding for the lane-packed kernel layout: the
    smallest threshold >= kmer_threshold whose PACKED width (strips merged
    to max_segs, pack_strips) fits max_lanes.

    This is the reference's own memory-budget walk (diagenv.cpp:60-106)
    with the device cost model: on long noisy reads vs large references,
    dozens of spurious threshold-level seed diagonals scatter across the
    whole diagonal range — the reference's ragged storage pays them
    per-diagonal, but a dense max_segs-packed layout pays the gap unions
    (measured: a 25 kb read's threshold-20 envelope packs to 124k lanes
    where the true cluster needs ~300).  The kernel paths call this when
    a pair's packed width exceeds their VMEM/HBM stream budgets; the f64
    parity paths never do.

    Diagonal 0 is always included (diagenv.cpp:52-54).  Seed levels are
    walked from the highest match count down, accepting a level only
    while the packed width stays within budget; the walk always accepts
    at least the top level so the true seed cluster survives even a tiny
    budget."""
    x_len, y_len = len(x.seq), len(y_index.seq.seq)
    diags_arr, counts_arr = diagonal_kmer_counts(
        x.tokens(), y_index, x_len, y_len
    )
    min_diag = 1 - y_len
    max_diag = x_len - 1
    half_band = band_size // 2

    order = np.argsort(counts_arr)[::-1]
    levels: list[np.ndarray] = []
    if len(order):
        sorted_counts = counts_arr[order]
        sorted_diags = diags_arr[order]
        boundaries = np.nonzero(np.diff(sorted_counts))[0] + 1
        split_points = np.concatenate([[0], boundaries, [len(sorted_counts)]])
        for a, b in zip(split_points[:-1], split_points[1:]):
            if int(sorted_counts[a]) < kmer_threshold:
                break
            levels.append(sorted_diags[a:b])

    def packed_width(member: set) -> int:
        env = Envelope(
            x_len=x_len,
            y_len=y_len,
            diagonals=np.array(sorted(member), dtype=np.int64),
        )
        return sum(s.band_width for s in pack_strips(env, max_segs))

    member = {0}
    for lvl, seed_diags in enumerate(levels):
        more = set(member)
        for seed in seed_diags:
            d_min = max(min_diag, int(seed) - half_band)
            d_max = min(max_diag, int(seed) + half_band)
            more.update(range(d_min, d_max + 1))
        if lvl > 0 and packed_width(more) > max_lanes:
            break
        member = more
    return Envelope(
        x_len=x_len,
        y_len=y_len,
        diagonals=np.array(sorted(member), dtype=np.int64),
    )
