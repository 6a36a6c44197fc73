"""The `quaff overlap` pipeline on PyTorch: read-vs-read overlap of every
ordered read pair, scored by K4 on the device, filled and walked back in
float64 on the host.

Ported from quaff_tpu/overlap.py, which replaces the reference's
QuaffOverlapAligner / QuaffOverlapTask / QuaffOverlapScheduler
(src/qoverlap.cpp:304-613): the pair-emission tables are built once per
(params, strand), pairs are enumerated in the reference's order (each
original read against every later read, reverse-complement copies
included), and each pair's banded overlap Viterbi is filled in float64 by
the port's host library, with the reference's traceback (its adjacent
insert/delete squashing included, qoverlap.cpp:231-267).

Two routes, as in the JAX package:

  batched     more than one pair and no `-log dpmatrix`: every pair is
              scored by K4 (dp/ov_fill.py) on `config.device` (the CUDA
              kernel on a card, its plain version on the CPU); pairs whose
              score cannot clear the report threshold are dropped, and the
              rest go through the float64 exact pass, whose text decides
              the output
  sequential  one pair, or `-log dpmatrix`: one bounding-band float64 fill
              with matrices per pair, then the traceback

With -mesh (`mesh`, a parallel/distributed.GlobalMesh) K4's chunks are
dealt to the ranks in turn, each rank scores its own on its device, the
scores (strip maxima included) are all_gathered, and rank 0 alone runs the
exact pass and writes (quaff_tpu/overlap.py's _mesh_overlap_scores).

Not ported here: the JAX package's TPU workarounds (interpret mode,
the VMEM cell budget and kernel-warmth gates, the small-workload native
gate, bit-packed masks, power-of-two batch padding, 128-lane and 512-row
rounding, the pipeline chunk count, the device-side bank reversal, and the
streamed prep, which lost pairs).
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import IO, List, Optional, Tuple

import numpy as np
import torch

from .aligner import VITERBI_CELL_SIZE, DPConfig
from .device import resolve_device
from .dp.engine import PairBatch, pow2ceil
from .dp.overlap import OverlapScoreTables
from .dp.ov_fill import (
    MAX_SEGS,
    OV_LANE_CAP,
    bank_rows,
    overlap_scores,
    ov_tables,
    packed_overlap_descriptors,
)
from .dp.scores import ScoreTables
from .dp.traceback import _cols_to_str
from .envelope import Envelope, fit_envelope_lanes, pack_strips
from .formats.alignment import GAP_CHAR, Alignment, AlignmentPrinter
from .io.fastseq import FastSeq, KmerIndex, SeqIntervalCoords
from .logger import logger
from .model.params import QuaffNullParams, QuaffParams
from .native import (
    _overlap_tabs,
    overlap_fill_native,
    overlap_score_native,
    overlap_strip_score_native,
    overlap_traceback_cols,
    overlap_viterbi_path_cols_batch,
)

NEG_INF = -math.inf

# K4 chunks: at most this many pairs, and at most B*W lanes within a
# budget of device memory (BYTES_PER_LANE covers the plain version's
# [B, C, W] gathers; the kernel itself needs 4 bytes a lane of input)
MAX_BATCH = 1024
BYTES_PER_LANE = 256
CPU_CHUNK_BYTES = 1 << 30
# exact-pass pool tasks: pairs per batched native call
EXACT_SLICE = 12
# kernel-vs-float64 margins: K4 uses exact log-sum-exp where the float64
# fill uses the reference's truncated tables (~1e-5 nats a column), so a
# pair is kept within SCORE_SLACK nats of the report threshold and a strip
# within STRIP_SLACK nats of the pair's best strip.  Correctness margins,
# not tuning knobs: a kernel error beyond them drops alignments.
SCORE_SLACK = 1.0
STRIP_SLACK = 0.25


def _y_strand_arrays(y: FastSeq, tables: OverlapScoreTables):
    """Per-position token/k-mer arrays for the second read.

    For reverse-strand pairs the reference scores the stored revcomp copy
    with arrays from the double-revcomp (= original) sequence, reversed
    back into the stored copy's coordinates (qoverlap.cpp:91-103); the
    quality array stays in stored coordinates.
    """
    if tables.y_complemented:
        y2 = y.revcomp()
        y_tok = y2.tokens()[::-1].copy()
        y_mk = y2.kmers(tables.match_kmer_len)[::-1].copy()
        y_ik = y2.kmers(tables.indel_kmer_len)[::-1].copy()
    else:
        y_tok = y.tokens()
        y_mk = y.kmers(tables.match_kmer_len)
        y_ik = y.kmers(tables.indel_kmer_len)
    y_q = y.qual_scores() if y.has_qual() else None
    return y_tok, y_mk, y_ik, y_q


def _insert_score_sum(tables: OverlapScoreTables, tok, qual) -> float:
    if qual is not None and len(qual) == len(tok):
        return float(np.sum(tables.insert_score[tok, qual]))
    return float(np.sum(tables.insert_score_noq[tok]))


class OverlapBatch:
    """A PairBatch plus the x-side context arrays the overlap model needs
    (both sequences carry k-mer contexts and quality scores)."""

    def __init__(self, pairs: List[Tuple[FastSeq, FastSeq, Envelope]],
                 tables: OverlapScoreTables):
        st = ScoreTables.__new__(ScoreTables)  # only kmer lens used by build
        st.match_kmer_len = tables.match_kmer_len
        st.indel_kmer_len = tables.indel_kmer_len
        self.base = PairBatch.build(pairs, st)
        B = len(pairs)
        Lx = self.base.x_tok.shape[1]
        self.x_match_kmer = np.zeros((B, Lx), dtype=np.int32)
        self.x_indel_kmer_pad = np.zeros((B, Lx + 1), dtype=np.int32)
        self.x_qual = np.zeros((B, Lx), dtype=np.int32)
        self.x_has_qual = np.zeros(B, dtype=bool)
        self.x_insert_score = np.zeros(B)
        self.y_insert_score = np.zeros(B)
        for b, (x, y, env) in enumerate(pairs):
            lx = len(x.seq)
            x_tok = x.tokens()
            self.x_match_kmer[b, :lx] = x.kmers(tables.match_kmer_len)
            self.x_indel_kmer_pad[b, 1 : lx + 1] = x.kmers(tables.indel_kmer_len)
            xq = x.qual_scores() if x.has_qual() else None
            if xq is not None:
                self.x_qual[b, :lx] = xq
                self.x_has_qual[b] = True
            self.x_insert_score[b] = _insert_score_sum(tables, x_tok, xq)
            y_tok, y_mk, y_ik, y_q = _y_strand_arrays(y, tables)
            ly = len(y.seq)
            self.base.y_tok[b, :ly] = y_tok
            self.base.y_match_kmer[b, :ly] = y_mk
            self.base.y_indel_kmer_pad[b, 1 : ly + 1] = y_ik
            self.y_insert_score[b] = _insert_score_sum(tables, y_tok, y_q)


def overlap_traceback(
    x: FastSeq,
    y: FastSeq,
    env: Envelope,
    tables: OverlapScoreTables,
    mat: np.ndarray,
    ins: np.ndarray,
    dele: np.ndarray,
    result: float,
) -> Alignment:
    """QuaffOverlapViterbiMatrix::alignment (qoverlap.cpp:162-290) over the
    matrices of a bounding-band fill, walked by the host library
    (qdp_overlap_traceback)."""
    x_q = x.qual_scores() if x.has_qual() else None
    _, y_mk, y_ik_raw, y_q = _y_strand_arrays(y, tables)
    cols = overlap_traceback_cols(
        x.kmers(tables.match_kmer_len),
        np.concatenate([[0], x.kmers(tables.indel_kmer_len)]),
        x_q, len(x.seq), x_q is not None,
        y_mk, np.concatenate([[0], y_ik_raw]), y_q, len(y.seq),
        y_q is not None,
        tables, 0, env.band_lo, mat, ins, dele,
    )
    return _cols_alignment(x, y, cols, result)


def _cols_alignment(x: FastSeq, y: FastSeq, cols, score: float) -> Alignment:
    """The two-row alignment of a traceback's columns (-1 = gap)."""
    col_x, col_y, x_start, x_end, y_start, y_end = cols
    row_x = FastSeq(name="read_x", comment=f"substr({x.name},{x_start}..{x_end})")
    row_y = FastSeq(name="read_y", comment=f"substr({y.name},{y_start}..{y_end})")
    row_x.seq = _cols_to_str(col_x, x.seq, GAP_CHAR)
    row_y.seq = _cols_to_str(col_y, y.seq, GAP_CHAR)
    if x.has_qual():
        row_x.qual = _cols_to_str(col_x, x.qual, "~")
    if y.has_qual():
        row_y.qual = _cols_to_str(col_y, y.qual, "~")
    row_x.source = SeqIntervalCoords(x.name, x_start, x_end, False).compose(x.source)
    row_y.source = SeqIntervalCoords(y.name, y_start, y_end, False).compose(y.source)
    return Alignment(gapped_seq=[row_x, row_y], score=score)


class QuaffOverlapAligner:
    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        self.device = resolve_device(config.device)
        # The pair-emission tables are the overlap mode's dominant fixed
        # cost (a 16*16*94*94 truncated-lse build); they are cached ON the
        # params object, so an aligner built per batch with the same
        # params reuses them.  The reference rebuilds them per task
        # (qoverlap.cpp:77-79).  Params objects are treated as immutable
        # (the trainer's M-step returns a new QuaffParams).
        cache = params.__dict__.get("_overlap_table_cache")
        if cache is None:
            base = ScoreTables.from_params(params)
            cache = params.__dict__["_overlap_table_cache"] = {
                "base": base,
                False: OverlapScoreTables.from_params(params, False, base),
            }
        self._tcache = cache
        self.mesh = None  # -mesh: the GlobalMesh (the CLI sets it)

    def _tables(self, y_complemented: bool) -> OverlapScoreTables:
        """The tables of a strand; the reverse strand's build lazily (not
        thread-safe: build them on the main thread before a pool starts)."""
        if y_complemented not in self._tcache:
            self._tcache[y_complemented] = OverlapScoreTables.from_params(
                self.params, y_complemented, self._tcache["base"]
            )
        return self._tcache[y_complemented]

    def _null_ll(self, seq: FastSeq, comp: bool = False) -> float:
        """Null log-likelihood of a read (of its revcomp when comp),
        memoized on the FastSeq: in all-vs-all runs each read's value is
        needed once per pair it appears in."""
        key = (id(self.null_model), comp)
        cache = seq.__dict__.setdefault("_null_ll_cache", {})
        if key not in cache:
            s = seq.revcomp() if comp else seq
            cache[key] = self.null_model.log_likelihood(s)
        return cache[key]

    def enumerate_pairs(self, seqs: List[FastSeq], n_originals: int):
        """The reference scheduler's pair order (qoverlap.cpp:475-547):
        (nx, ny) ascending with nx < ny, stopping once nx+1 >= nOriginals;
        ny >= nOriginals means the second read is a revcomp copy."""
        for nx in range(len(seqs)):
            if nx + 1 >= n_originals:
                break
            for ny in range(nx + 1, len(seqs)):
                yield nx, ny, ny >= n_originals

    def _finish_pair(
        self,
        x: FastSeq,
        y: FastSeq,
        y_complemented: bool,
        env: Envelope,
        tables: OverlapScoreTables,
        res: dict,
        b: int,
    ) -> Optional[Alignment]:
        score = float(res["score"][b])
        if not math.isfinite(score):
            return None
        if logger.logging_tag("dpmatrix"):
            from .dp.debug import write_dp_matrix

            write_dp_matrix(
                x, y, env, res["mat"][b], res["ins"][b], res["del"][b], score
            )
        a = overlap_traceback(
            x, y, env, tables, res["mat"][b], res["ins"][b], res["del"][b],
            score,
        )
        a.score -= self._null_ll(x) + self._null_ll(y, y_complemented)
        return a

    def overlap_pair(
        self, x: FastSeq, y: FastSeq, y_complemented: bool
    ) -> Optional[Alignment]:
        tables = self._tables(y_complemented)
        y_index = KmerIndex(y, self.config.kmer_len)
        env = self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE)
        batch = OverlapBatch([(x, y, env)], tables)
        res = overlap_fill_native(batch, tables)
        return self._finish_pair(x, y, y_complemented, env, tables, res, 0)

    def align_all(
        self,
        out: IO[str],
        seqs: List[FastSeq],
        n_originals: int,
        printer: AlignmentPrinter,
    ) -> None:
        """The `quaff overlap` pipeline: header, then every reported pair
        in the reference's pair order.  Several pairs take the batched
        route; one pair and `-log dpmatrix` (full-envelope matrix dumps)
        take the sequential route."""
        printer.write_header(out, seqs, group_by_query=False)
        pair_list = list(self.enumerate_pairs(seqs, n_originals))
        if len(pair_list) > 1 and not logger.logging_tag("dpmatrix"):
            self._align_all_batched(out, seqs, pair_list, printer)
        else:
            self._align_all_sequential(out, seqs, pair_list, printer)

    def _align_all_sequential(self, out, seqs, pair_list, printer) -> None:
        """Per pair: one bounding-band float64 fill with matrices and its
        traceback, in pair order (no kernel, no pruning).  With a report
        threshold, a matrix-free float64 score prepass first skips the
        pairs the printer would drop, with the same bytes out."""
        skip = None
        if (
            len(pair_list) > 1
            and printer.log_odds_threshold > NEG_INF
            and not logger.logging_tag("dpmatrix")
        ):
            skip = self._cpu_score_prepass(seqs, pair_list, printer)
        for k, (nx, ny, y_comp) in enumerate(pair_list):
            if skip is not None and skip[k]:
                continue
            a = self.overlap_pair(seqs[nx], seqs[ny], y_comp)
            if a is not None:
                printer.write_alignment(out, a)

    def _cpu_score_prepass(self, seqs, pair_list, printer,
                           chunk_size: int = 32) -> List[bool]:
        """Score-only float64 prepass of the sequential route: every pair's
        null-adjusted score from the matrix-free native fill (bitwise equal
        to the full fill's score, thread-pooled), marking the pairs the
        printer would drop below its log-odds threshold.  Output is
        byte-identical to filling every pair (the reference also fills
        everything and thresholds at print time, qmodel.cpp:2570-2572)."""
        y_indexes: dict = {}
        skip = [False] * len(pair_list)
        for y_comp in (False, True):
            idxs = [k for k, (_, _, yc) in enumerate(pair_list) if yc == y_comp]
            if not idxs:
                continue
            tables = self._tables(y_comp)
            for c0 in range(0, len(idxs), chunk_size):
                sub = idxs[c0 : c0 + chunk_size]
                pairs = []
                for k in sub:
                    nx, ny, _ = pair_list[k]
                    if ny not in y_indexes:
                        y_indexes[ny] = KmerIndex(seqs[ny], self.config.kmer_len)
                    env = self.config.make_envelope(
                        seqs[nx], y_indexes[ny], VITERBI_CELL_SIZE
                    )
                    pairs.append((seqs[nx], seqs[ny], env))
                sc = overlap_score_native(OverlapBatch(pairs, tables), tables)
                for k, s in zip(sub, sc):
                    nx, ny, _ = pair_list[k]
                    adj = s - self._null_ll(seqs[nx]) - self._null_ll(seqs[ny], y_comp)
                    skip[k] = adj < printer.log_odds_threshold
        return skip

    # ---- the batched route ------------------------------------------------

    def _pair_jobs(self, seqs, pair_list) -> list:
        """Envelopes of every pair: [((nx, ny, y_comp, env), desc, wide)],
        desc the pair's packed_overlap_descriptors.  A pair whose packed
        width exceeds OV_LANE_CAP is re-banded by the memory-fitted walk
        (fit_envelope_lanes), the policy of align and the E-step; still too
        wide, it is `wide` and goes straight to the exact pass, which
        handles any width."""
        index_cache = {ny: KmerIndex(seqs[ny], self.config.kmer_len)
                       for ny in sorted({ny for _, ny, _ in pair_list})}

        def job(p):
            nx, ny, y_comp = p
            env = self.config.make_envelope(seqs[nx], index_cache[ny],
                                            VITERBI_CELL_SIZE)
            wide = False
            if self.config.sparse:
                if sum(s.band_width for s in pack_strips(env)) > OV_LANE_CAP:
                    env = fit_envelope_lanes(
                        seqs[nx], index_cache[ny], OV_LANE_CAP,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                    wide = sum(s.band_width for s in pack_strips(env)) > OV_LANE_CAP
            desc = packed_overlap_descriptors(
                [env], [len(seqs[nx].seq)], [len(seqs[ny].seq)]
            )
            return (nx, ny, y_comp, env), desc, wide

        # thread the envelopes only for long reads: the build is mostly
        # GIL-bound Python around the native k-mer join, and pooling it
        # measured slower at all-vs-all read lengths (quaff_tpu/overlap.py)
        total_bases = sum(len(s.seq) for s in seqs)
        if (self.config.threads > 1
                and total_bases / max(len(seqs), 1) > 16384):
            with ThreadPoolExecutor(self.config.threads) as ex:
                return list(ex.map(job, pair_list))
        return [job(p) for p in pair_list]

    def _chunk_lane_cap(self) -> int:
        """Most B*W lanes one K4 chunk may hold: an eighth of the card's
        memory, or CPU_CHUNK_BYTES on the host."""
        if self.device.type == "cuda":
            budget = torch.cuda.get_device_properties(self.device).total_memory // 8
        else:
            budget = CPU_CHUNK_BYTES
        return budget // BYTES_PER_LANE

    def _chunks(self, scored_jobs, packed) -> list:
        """K4 chunks: per width class (packed widths within a power of two),
        pairs sorted by live rows (longest first) and cut at MAX_BATCH pairs
        or the lane budget.  Each block of the kernel stops at its own
        pair's rows and lanes, so neither needs padding, but its shared
        memory (and the plain version's tensors) is sized by the chunk's
        widest pair.  Both strands share a chunk: the bank's y rows carry
        each strand's complement folding."""
        lane_cap = self._chunk_lane_cap()

        def width(j):
            return packed[(j[0], j[1])][0].shape[1]

        groups: dict = {}
        for j in scored_jobs:
            groups.setdefault(pow2ceil(width(j), 32), []).append(j)
        chunks = []
        for _, js in sorted(groups.items()):
            js.sort(key=lambda j: -int(packed[(j[0], j[1])][5][0]))
            chunk, wmax = [], 0
            for j in js:
                wj = width(j)
                if chunk and (len(chunk) == MAX_BATCH
                              or (len(chunk) + 1) * max(wmax, wj) > lane_cap):
                    chunks.append(chunk)
                    chunk, wmax = [], 0
                chunk.append(j)
                wmax = max(wmax, wj)
            if chunk:
                chunks.append(chunk)
        return chunks

    def _bank(self, seqs, jobs):
        """The sequence bank on the device: one bank_rows row per x read
        and per (y read, strand), each once.  Returns (bank [N, C, L],
        {("x", i) or ("y", i, y_comp): row})."""
        keys = sorted({("x", nx) for nx, _, _, _ in jobs}) + sorted(
            {("y", ny, yc) for _, ny, yc, _ in jobs})
        L = max(len(seqs[k[1]].seq) for k in keys)
        parts, row_of = [], {}
        groups = [("x", [k for k in keys if k[0] == "x"], False),
                  ("y", [k for k in keys if k[0] == "y" and not k[2]], False),
                  ("y", [k for k in keys if k[0] == "y" and k[2]], True)]
        for side, ks, comp in groups:
            if not ks:
                continue
            tables = self._tables(comp)
            n = len(ks)
            tok, mk, ik, q = (np.zeros((n, L), np.int32) for _ in range(4))
            hq = np.zeros(n, bool)
            lens = np.zeros(n, np.int32)
            for r, k in enumerate(ks):
                s = seqs[k[1]]
                if side == "x":
                    t = s.tokens()
                    m = s.kmers(tables.match_kmer_len)
                    i = s.kmers(tables.indel_kmer_len)
                    qs = s.qual_scores() if s.has_qual() else None
                else:
                    t, m, i, qs = _y_strand_arrays(s, tables)
                ln = len(t)
                tok[r, :ln], mk[r, :ln], ik[r, :ln] = t, m, i
                if qs is not None:
                    q[r, :ln] = qs
                    hq[r] = True
                lens[r] = ln
                row_of[k] = sum(p.shape[0] for p in parts) + r
            dev = self.device
            parts.append(bank_rows(
                ov_tables(tables, dev), side,
                *(torch.from_numpy(a).to(dev) for a in (tok, mk, ik, q, hq, lens))
            ))
        return torch.cat(parts).contiguous(), row_of

    def _kernel_batches(self, seqs, chunks, packed):
        """K4's batches of chunks of jobs: yields (chunk, batch), batch a
        `prepare` bank-form dict of tensors on the device.  The sequence
        bank is built once, each (read, strand) once."""
        bank, row_of = self._bank(seqs, [j for c in chunks for j in c])
        ins_cache: dict = {}

        def insert_sum(i, comp=False):
            if (i, comp) not in ins_cache:
                tables = self._tables(comp)
                tok, _, _, q = _y_strand_arrays(seqs[i], tables)
                ins_cache[(i, comp)] = _insert_score_sum(tables, tok, q)
            return ins_cache[(i, comp)]

        for chunk in chunks:
            B = len(chunk)
            W = max(packed[(nx, ny)][0].shape[1] for nx, ny, _, _ in chunk)
            member = np.zeros((B, W), bool)
            seg = np.zeros((3, B, MAX_SEGS), np.int32)
            j_off = np.zeros(B, np.int32)
            n_rows = np.zeros(B, np.int32)
            for b, (nx, ny, yc, env) in enumerate(chunk):
                m1, sd, ss, sw, jo, rows = packed[(nx, ny)]
                member[b, : m1.shape[1]] = m1[0]
                seg[0, b], seg[1, b], seg[2, b] = sd[0], ss[0], sw[0]
                j_off[b], n_rows[b] = jo[0], rows[0]
            host = {
                "x_row": [row_of[("x", nx)] for nx, _, _, _ in chunk],
                "y_row": [row_of[("y", ny, yc)] for _, ny, yc, _ in chunk],
                "x_len": [len(seqs[nx].seq) for nx, _, _, _ in chunk],
                "y_len": [len(seqs[ny].seq) for _, ny, _, _ in chunk],
                "member": member, "seg_d_lo": seg[0], "seg_start": seg[1],
                "seg_width": seg[2], "j_off": j_off, "n_rows": n_rows,
                "x_insert_score": [insert_sum(nx) for nx, _, _, _ in chunk],
                "y_insert_score": [insert_sum(ny, yc) for _, ny, yc, _ in chunk],
            }
            batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                     for k, v in host.items()}
            batch["bank"] = bank
            yield chunk, batch

    def _align_all_batched(self, out, seqs, pair_list, printer) -> None:
        """All-vs-all overlap: K4 scores every pair (and each of its
        strips), then only pairs whose null-adjusted score can clear the
        report threshold, and only their strips that can hold the winner,
        go through the float64 exact pass.  The exact pass runs on a pool
        that starts before the device work; its alignments are written in
        pair order as they land."""
        threshold = printer.log_odds_threshold
        built = self._pair_jobs(seqs, pair_list)
        jobs = [job for job, _, _ in built]
        packed = {(job[0], job[1]): desc for job, desc, _ in built}
        wide_pairs = {(job[0], job[1]) for job, _, wide in built if wide}
        # with the threshold at -inf the kernel's score filter is dead: its
        # only use is the strip maxima that winnow the exact pass's strip
        # fills, which a single-strip pair does not need, so such a pair
        # skips the kernel and its exact fill starts at once
        single_set = set()
        if threshold == NEG_INF:
            single_set = {
                (nx, ny) for nx, ny, _, _ in jobs
                if (nx, ny) not in wide_pairs
                and int(np.count_nonzero(packed[(nx, ny)][3][0])) <= 1
            }
        direct = wide_pairs | single_set
        scored_jobs = [j for j in jobs if (j[0], j[1]) not in direct]
        chunks = self._chunks(scored_jobs, packed) if scored_jobs else []
        gathered = None
        if self.mesh is not None:
            # -mesh: chunk i on rank i % ranks, every chunk's scores on
            # every rank; rank 0 alone runs the exact pass and writes
            from .parallel.distributed import is_primary
            from .parallel.estep import sharded_scores

            mine = list(self.mesh.chunks_of_rank(len(chunks)))
            batches = self._kernel_batches(seqs, [chunks[i] for i in mine],
                                           packed)
            # sharded_scores asks for this rank's chunks in `mine` order
            gathered = sharded_scores(
                self.mesh, len(chunks),
                lambda i: overlap_scores(self._tables(False),
                                         next(batches)[1]))
            if not is_primary():
                return

        # every strand's tables on the main thread before the pool starts
        for yc in {j[2] for j in jobs}:
            self._tables(yc)
        x_cache: dict = {}
        y_cache: dict = {}
        exact_futs = []
        pool = ThreadPoolExecutor(os.cpu_count() or 1)

        def submit(cands_, seg_scores=None):
            work = self._path_worker(seqs, x_cache, y_cache,
                                     self._strip_jobs(seqs, cands_, seg_scores))
            items = work.items
            # heaviest first: the pool drains FIFO, so an expensive pair
            # queued last would become the pole of the whole pass
            items.sort(key=lambda it: -sum(r * s.band_width for s, _, r in it[1]))
            for i in range(0, len(items), EXACT_SLICE):
                exact_futs.append(pool.submit(work, items[i : i + EXACT_SLICE]))

        try:
            direct_jobs = [j for j in jobs if (j[0], j[1]) in direct]
            if direct_jobs:
                submit(direct_jobs)

            scored, seg_scored = {}, {}
            if scored_jobs:
                # enqueue every chunk, then drain in order: each chunk's
                # candidates start their exact fills while later chunks
                # still run on the device
                # (the transitions K4 takes are the same on both strands)
                if gathered is None:
                    pending = [
                        (chunk, overlap_scores(self._tables(False), batch))
                        for chunk, batch in self._kernel_batches(
                            seqs, chunks, packed)
                    ]
                else:
                    pending = [(chunk, torch.from_numpy(g))
                               for chunk, g in zip(chunks, gathered)]
                for chunk, dev in pending:
                    host = dev.cpu().numpy().astype(np.float64)
                    B = len(chunk)
                    segs = host[B:].reshape(B, -1)
                    cands_ = []
                    for b, (nx, ny, yc, env) in enumerate(chunk):
                        scored[(nx, ny)] = float(host[b])
                        seg_scored[(nx, ny)] = segs[b]
                        if self._keep(seqs, nx, ny, yc, host[b], threshold):
                            cands_.append((nx, ny, yc, env))
                    if cands_:
                        submit(cands_, seg_scored)

            cands = [
                job for job in jobs
                if (job[0], job[1]) in direct
                or self._keep(seqs, job[0], job[1], job[2],
                              scored[(job[0], job[1])], threshold)
            ]
            # ordered incremental flush: futures complete out of order, but
            # result() waits in submission order; after each one, every
            # leading candidate whose alignment is known is written, so the
            # (GIL-bound) rendering overlaps the remaining native fills.
            # Never as_completed: the output order is the pair order.
            results: dict = {}
            cursor = 0
            for f in exact_futs:
                results.update(f.result())
                while cursor < len(cands):
                    key = (cands[cursor][0], cands[cursor][1])
                    if key not in results:
                        break
                    if results[key] is not None:
                        printer.write_alignment(
                            out, self._render_path(seqs, results[key]))
                    cursor += 1
            if cursor != len(cands):
                raise RuntimeError(
                    f"overlap: {len(cands) - cursor} candidate pairs got no "
                    "exact-pass result"
                )
        finally:
            pool.shutdown()

    def _keep(self, seqs, nx, ny, yc, score, threshold) -> bool:
        """A kernel-scored pair goes to the exact pass unless its score is
        -inf or its null-adjusted score is more than SCORE_SLACK below the
        report threshold."""
        if not math.isfinite(score):
            return False
        adj = score - self._null_ll(seqs[nx]) - self._null_ll(seqs[ny], yc)
        return adj >= threshold - SCORE_SLACK

    def _path_worker(self, seqs, x_cache, y_cache, jobs):
        """The float64 exact pass's work on shared lazy caches: work(items)
        runs a slice of (job, strips) items through ONE batched native call
        and returns {(nx, ny): payload or None}; work.items holds `jobs`.

        Per item, score-only float64 fills pick the winning strip (only when
        more than one strip survived), then a checkpointed fill + traceback
        walks it; no DP matrix is kept.  Strips are independent DP
        subproblems (Envelope.strips), so this equals the bounding-band fill
        and traceback of overlap_pair, byte for byte.  The per-(seq, strand)
        array caches fill lazily and tolerate concurrent duplicate computes
        (the values are deterministic).  A payload becomes an Alignment by
        _render_path on the writer thread: the string building is GIL-bound,
        and pool workers that render contend for the GIL with each other's
        native fills."""
        for (nx, ny, yc, env), _ in jobs:
            _overlap_tabs(self._tables(yc))
            self._null_ll(seqs[nx])
            self._null_ll(seqs[ny], yc)

        def get_x(nx, yc):
            v = x_cache.get((nx, yc))
            if v is None:
                tables = self._tables(yc)
                x = seqs[nx]
                x_q = x.qual_scores() if x.has_qual() else None
                v = (
                    x.kmers(tables.match_kmer_len),
                    np.concatenate([[0], x.kmers(tables.indel_kmer_len)]),
                    x_q,
                    _insert_score_sum(tables, x.tokens(), x_q),
                )
                x_cache[(nx, yc)] = v
            return v

        def get_y(ny, yc):
            v = y_cache.get((ny, yc))
            if v is None:
                tables = self._tables(yc)
                y_tok, y_mk, y_ik_raw, y_q = _y_strand_arrays(seqs[ny], tables)
                v = (
                    y_mk,
                    np.concatenate([[0], y_ik_raw]),
                    y_q,
                    _insert_score_sum(tables, y_tok, y_q),
                )
                y_cache[(ny, yc)] = v
            return v

        def pick(item):
            """Winner strip + the native call's argument tuple for one item."""
            (nx, ny, yc, env), strips = item
            tables = self._tables(yc)
            x_mk, x_ik_pad, x_q, x_ins = get_x(nx, yc)
            y_mk, y_ik_pad, y_q, y_ins = get_y(ny, yc)
            x_len = len(seqs[nx].seq)
            y_len = len(seqs[ny].seq)
            best = 0
            if len(strips) > 1:
                best_sc = None
                for k, (s, off, rows) in enumerate(strips):
                    end = overlap_strip_score_native(
                        x_mk, x_ik_pad, x_q, x_len, x_q is not None,
                        y_mk, y_ik_pad, y_q, y_len, y_q is not None,
                        off, rows, s.band_lo, s.band_width,
                        s.member_mask(), tables,
                    )
                    # the summed-score comparison (first wins ties) of the
                    # matrix fill's res["score"] argmax
                    sc = (end + x_ins) + y_ins
                    if best_sc is None or sc > best_sc:
                        best_sc, best = sc, k
            s, off, rows = strips[best]
            return (nx, ny, yc, x_ins, y_ins, (
                x_mk, x_ik_pad, x_q, x_len, x_q is not None,
                y_mk, y_ik_pad, y_q, y_len, y_q is not None,
                off, rows, s.band_lo, s.band_width, s.member_mask(), tables,
            ))

        def work(items):
            picks = [pick(item) for item in items]
            res = overlap_viterbi_path_cols_batch([p[5] for p in picks])
            results = {}
            for (nx, ny, yc, x_ins, y_ins, _), (cols, end) in zip(picks, res):
                score = (end + x_ins) + y_ins
                results[(nx, ny)] = (
                    (nx, ny, yc, cols, score)
                    if cols is not None and math.isfinite(score) else None)
            return results

        work.items = list(jobs)
        return work

    def _render_path(self, seqs, payload) -> Alignment:
        """The Alignment of a _path_worker payload."""
        nx, ny, yc, cols, score = payload
        a = _cols_alignment(seqs[nx], seqs[ny], cols, score)
        a.score -= self._null_ll(seqs[nx]) + self._null_ll(seqs[ny], yc)
        return a

    def _strip_jobs(self, seqs, cands, seg_scores=None,
                    seg_slack: float = STRIP_SLACK) -> list:
        """Strip selection for the exact pass: each candidate becomes
        (job, [(strip, row_off, rows), ...]) with only the strips that can
        supply the winning traceback.  With K4's per-strip end maxima
        (seg_scores, pack_strips order), only strips within seg_slack nats
        of the pair's best strip are kept: the others (typically the
        always-included diagonal-0 strip, diagenv.cpp:53) never supply the
        traceback, so their float64 fills would be waste."""
        jobs: list = []
        for job in cands:
            nx, ny, y_comp, env = job
            x_len, y_len = len(seqs[nx].seq), len(seqs[ny].seq)
            segs = pack_strips(env, MAX_SEGS)
            keep = range(len(segs))
            if seg_scores is not None and (nx, ny) in seg_scores:
                sm = seg_scores[(nx, ny)]
                best = max((sm[k] for k in range(len(segs))), default=-math.inf)
                if math.isfinite(best):
                    keep = [k for k in range(len(segs))
                            if sm[k] >= best - seg_slack]
            strips = []
            for k in keep:
                s = segs[k]
                # live row window of the strip: member diagonal d has
                # cells at rows j with 1 <= d + j <= x_len
                d1, d2 = int(s.diagonals[0]), int(s.diagonals[-1])
                j0 = max(1, 1 - d2)
                rows = max(min(y_len, x_len - d1) - j0 + 1, 1)
                strips.append((s, j0 - 1, rows))
            jobs.append((job, strips))
        return jobs
