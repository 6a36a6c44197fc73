"""Baum-Welch EM training and E-step counting on PyTorch.

Ported from quaff_tpu/trainer.py (QuaffTrainer / QuaffCountingScheduler /
the counting tasks of src/qmodel.cpp:1909-2478).  The reference's per-read
bookkeeping is kept exactly, so EM trajectories match: the null-model
baseline, the running log-likelihood, the Delta=20 ref pruning, posterior
count weighting and best-first ref ordering (qmodel.cpp:2238-2271).

Two E-step routes, chosen as the JAX package chooses them:

  the fused E-step (dp/estep.estep_fused_multi): K2 forward fill with
      stored rows, read-level responsibilities on the device, K3 backward
      sweep with weighted counts.  For reads with qualities when the
      counter runs on a CUDA device; pairs of many reads share one launch.
  the exact engine (dp/counts.dp_forward_backward): reads without
      qualities, `-log postmatrix`, reads whose band is too wide for a
      chunk, and every read on the CPU.  float64 unless the caller asks for
      float32 (`count -fast`).

Not carried over: the TPU's cold-kernel CPU gate (_small_cpu_estep_gate,
KERNEL_WARM), its VMEM/HBM batch caps, the power-of-two batch padding with
a sentinel read group and the padding of W to 128.  A chunk is sized by a
fixed byte budget (ESTEP_CHUNK_BYTES, estep_chunk_plan); the JAX
multi-host and remote counting branches are not ported.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from .aligner import DPConfig
from .device import resolve_device
from .dp.counts import dp_forward_backward
from .dp.engine import PairBatch, table_tensors, to_device
from .dp.fill_v2 import V2Tables
from .dp.scores import ScoreTables
from .envelope import fit_envelope_lanes, pack_strips
from .io.fastseq import FastSeq, KmerIndex
from .logger import ProgressLogger, logger
from .model.params import (
    QuaffCounts,
    QuaffNullParams,
    QuaffParamCounts,
    QuaffParams,
)

# EM convergence parameters (reference qmodel.h:19-20)
MAX_EM_ITERATIONS = 100
MIN_EM_LOGLIKE_INC = 0.01

# drop refs whose log-likelihood trails the total by more than this
# (MAX_TRAINING_LOG_DELTA, qmodel.cpp:23)
MAX_TRAINING_LOG_DELTA = 20.0

# DP storage cost per cell of the memory-fitted envelope threshold:
# 6 doubles for Forward-Backward (reference qmodel.h:384)
FWDBACK_CELL_SIZE = 48

# Long-band guard of the fused E-step: a pair whose packed width exceeds
# this many lanes is re-banded with the memory-fitted walk
# (envelope.fit_envelope_lanes, diagenv.cpp:60-106); a read still wider
# after that takes the exact engine.  The same cap as align's.
ESTEP_LANE_CAP = 4096

# Chunk budget of the fused E-step, in device bytes (the reference's
# _ESTEP_HBM_BYTES, quaff_tpu/trainer.py:41).  It is a constant, not a
# share of the card's free memory, because it decides the output: which
# reads share a chunk (and so which float32 count tables are summed
# together) and which reads the kernels take at all.  Free memory changes
# with whatever else holds the card and between EM iterations (the caching
# allocator keeps the last chunk's blocks).  The phase-5 chunk of
# chip_smoke.py (B=256, W=168, 9956 rows, ~5.2e9 bytes) fits it whole.
ESTEP_CHUNK_BYTES = 6_000_000_000


def _log_sum_exp(a: float, b: float) -> float:
    if a == -math.inf:
        return b
    if b == -math.inf:
        return a
    m = max(a, b)
    return m + math.log1p(math.exp(-abs(a - b)))


def _pair_counts(res: dict, b: Optional[int], mk: int, ik: int) -> QuaffCounts:
    """One pair's counts (b) from per-pair engine results, or a batch's
    totals (b None) from the fused E-step."""
    def arr(k):
        v = res[k] if b is None else res[k][b]
        return np.asarray(v, dtype=np.float64)

    def scalar(k):
        return float(np.sum(arr(k)))

    return QuaffCounts(
        match_kmer_len=mk, indel_kmer_len=ik,
        insert=arr("insert_counts"), match=arr("match_counts"),
        m2m=arr("m2m"), m2i=arr("m2i"), m2d=arr("m2d"), m2e=arr("m2e"),
        i2i=scalar("i2i"), i2m=scalar("i2m"), d2d=scalar("d2d"),
        d2m=scalar("d2m"),
    )


def _ref_order(xy_loglike: np.ndarray, y_loglike: float) -> List[int]:
    """Best-first resort, pruning unproductive refs (qmodel.cpp:2264-2270)."""
    order = sorted(range(len(xy_loglike)), key=lambda nx: -xy_loglike[nx])
    return [nx for nx in order
            if xy_loglike[nx] >= y_loglike - MAX_TRAINING_LOG_DELTA]


def estep_chunk_plan(reads, pair_bytes, lane_cap=None, budget=None):
    """The fused E-step's chunk plan: which reads the float32 kernels take,
    and which of them share a launch.

    `reads` holds one (ny, rows, width, x_lens) per read that has jobs: the
    read's length, its widest packed band and the length of each job's
    ref; pair_bytes(width, rows, x_len) is one pair's device bytes.  A read
    goes to the exact engine (oversize) when its band is wider than
    lane_cap or its pairs together need more than the budget
    (ESTEP_CHUNK_BYTES unless given).  The rest form chunks of whole
    reads, longest first, while a chunk's padded shape (its widest band,
    its first read's rows, its longest ref) fits the budget; a read's
    pairs stay in one chunk because the in-chunk weights normalise over
    the read's refs.  Returns (chunks [[ny, ...]], oversize [ny]): a
    function of its arguments alone."""
    if budget is None:
        budget = ESTEP_CHUNK_BYTES
    kept, oversize = [], []
    for ny, rows, width, x_lens in reads:
        need = len(x_lens) * pair_bytes(width, rows, max(x_lens))
        if (lane_cap is not None and width > lane_cap) or need > budget:
            oversize.append(ny)
        else:
            kept.append((ny, rows, width, x_lens))
    kept.sort(key=lambda e: -e[1])
    chunks = []
    i = 0
    while i < len(kept):
        rows = kept[i][1]
        chunk, n, width, x_max = [], 0, 1, 1
        while i < len(kept):
            ny, _, wr, x_lens = kept[i]
            w2, x2 = max(width, wr), max([x_max] + list(x_lens))
            if chunk and (n + len(x_lens)) * pair_bytes(w2, rows, x2) > budget:
                break
            chunk.append(ny)
            n += len(x_lens)
            width, x_max = w2, x2
            i += 1
        chunks.append(chunk)
    return chunks, oversize


class QuaffCounter:
    """E-step count computation for reads against references on
    `config.device`.  `dtype` is the exact engine's (float64 parity, or
    float32 for `count -fast`); the fused kernels are float32."""

    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
        use_null_model: bool = True,
        dtype: torch.dtype = torch.float64,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        self.use_null_model = use_null_model
        self.dtype = dtype
        self.device = resolve_device(config.device)
        self.tables = ScoreTables.from_params(params)
        self._engine_tables = None
        self._v2tab = None

    def _use_kernel(self, y: FastSeq) -> bool:
        """The fused E-step takes reads with qualities on a card
        (quaff_tpu/trainer.py:109-116 routes the same way on the TPU)."""
        return self.device.type == "cuda" and y.has_qual()

    def _null_ll(self, y: FastSeq) -> float:
        return (self.null_model.log_likelihood(y) if self.use_null_model
                else -math.inf)

    def _envelopes(self, refs, y, sort_order):
        y_index = KmerIndex(y, self.config.kmer_len)
        return y_index, {
            nx: self.config.make_envelope(refs[nx], y_index, FWDBACK_CELL_SIZE)
            for nx in sort_order
        }

    def _engine(self, batch: PairBatch, want_post: bool) -> dict:
        if self._engine_tables is None:
            self._engine_tables = table_tensors(self.tables, self.dtype,
                                                self.device)
        res = dp_forward_backward(
            self._engine_tables, to_device(batch, self.device),
            local=self.config.local, dtype=self.dtype,
            num_match_kmers=self.params.num_match_kmers,
            num_indel_kmers=self.params.num_indel_kmers,
            return_post=want_post,
        )
        return {k: v.cpu().numpy() for k, v in res.items()}

    def count_read(
        self, refs: List[FastSeq], y: FastSeq, sort_order: List[int],
        force_engine: bool = False,
    ) -> Tuple[QuaffParamCounts, float, List[int]]:
        """One read's posterior-weighted counts against its refs
        (QuaffCountingTask::run, qmodel.cpp:2238-2271): (counts,
        log-likelihood, updated ref sort order).  force_engine takes the
        exact engine for a read whose band is too wide for the kernels."""
        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        y_null_ll = self._null_ll(y)
        if not sort_order:
            return QuaffParamCounts.zero(mk, ik), y_null_ll, sort_order
        want_post = logger.logging_tag("postmatrix")
        if not force_engine and not want_post and self._use_kernel(y):
            # the fused kernels never materialise posterior matrices; the
            # postmatrix dump takes the exact engine
            counts, ll, orders = self._get_counts_kernel_batched(
                refs, [y], [sort_order], None)
            return counts, ll, orders[0]

        y_counts = QuaffParamCounts.zero(mk, ik)
        _, envs = self._envelopes(refs, y, sort_order)
        pairs = [(refs[nx], y, envs[nx]) for nx in sort_order]
        res = self._engine(PairBatch.build(pairs, self.tables), want_post)
        fwd = np.asarray(res["fwd_score"], dtype=np.float64)
        back = np.asarray(res["back_score"], dtype=np.float64)
        # fwd/back self-check (MAX_FRACTIONAL_FWDBACK_ERROR,
        # qmodel.cpp:20,1496-1497)
        for f, bk in zip(fwd, back):
            if (math.isfinite(f) and math.isfinite(bk)
                    and abs(f - bk) > 1e-4 * min(abs(f), abs(bk))):
                logger.log(0, f"\n\nWarning: forward score ({f:g}) does not "
                              f"match backward score ({bk:g})\n\n\n")

        # the reference's running-loglike backward-skip
        xy_loglike = np.full(len(refs), -math.inf)
        took_backward = np.zeros(len(refs), dtype=bool)
        y_loglike = y_null_ll
        for pos, nx in enumerate(sort_order):
            xy_loglike[nx] = fwd[pos]
            if xy_loglike[nx] >= y_loglike - MAX_TRAINING_LOG_DELTA:
                took_backward[nx] = True
            y_loglike = _log_sum_exp(y_loglike, xy_loglike[nx])

        for pos, nx in enumerate(sort_order):
            if not took_backward[nx] or not math.isfinite(xy_loglike[nx]):
                continue
            if want_post:
                from .dp.debug import write_post_matrix

                write_post_matrix(refs[nx], y, envs[nx], res["post_mat"][pos],
                                  res["post_ins"][pos], res["post_del"][pos])
            post = math.exp(xy_loglike[nx] - y_loglike)
            y_counts.add_weighted(
                QuaffParamCounts.from_counts(_pair_counts(res, pos, mk, ik)),
                post)
        return y_counts, y_loglike, _ref_order(xy_loglike, y_loglike)

    def get_counts(
        self,
        refs: List[FastSeq],
        reads: List[FastSeq],
        sort_order: Optional[List[List[int]]] = None,
    ) -> Tuple[QuaffParamCounts, float, List[List[int]]]:
        """Counts summed over all reads (QuaffTrainer::getCounts).  When
        every read takes the fused E-step, pairs of many reads share each
        launch (the counterpart of the reference's read-level thread
        pool, qmodel.cpp:2005-2031)."""
        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        if sort_order is None:
            sort_order = [list(range(len(refs))) for _ in reads]
        plog = ProgressLogger(level=2)
        plog.init_progress("Expected counts (E-step)")
        if (not logger.logging_tag("postmatrix")
                and all(self._use_kernel(y) for y in reads)):
            out = self._get_counts_kernel_batched(refs, reads, sort_order,
                                                  plog)
            plog.done()
            return out
        total = QuaffParamCounts.zero(mk, ik)
        loglike = 0.0
        new_orders: List[List[int]] = []
        for ny, y in enumerate(reads):
            plog.log_progress(ny / max(len(reads), 1),
                              f"read {ny + 1}/{len(reads)}")
            y_counts, y_ll, order = self.count_read(refs, y, sort_order[ny])
            total.add_weighted(y_counts, 1.0)
            loglike += y_ll
            new_orders.append(order)
        plog.done()
        return total, loglike, new_orders

    def _pair_bytes(self, width: int, rows: int, x_len: int) -> int:
        """Device bytes one pair takes in a fused E-step chunk: K2's three
        stored float32 rows per lane and row, K3's per-pair count table and
        its row state in global scratch when the band is wide, the inputs."""
        Km, Q = self.tables.match_score.shape[1], self.tables.match_score.shape[2]
        table = 4 * (4 * Km * Q + 4 * Q + 4 * len(self.tables.m2m))
        return 12 * width * rows + table + 32 * width + x_len + 16 * rows

    def _get_counts_kernel_batched(self, refs, reads, sort_order, plog):
        """Cross-read fused E-step (quaff_tpu/trainer.py:396-603): the
        (read, ref) pairs of many reads go through estep_fused_multi in
        the chunks of estep_chunk_plan, the longest reads first; each read's
        log-likelihood and ref order are then rebuilt on the host in
        float64 as count_read does."""
        from .dp.estep import estep_fused_multi

        mk, ik = self.params.match_kmer_len, self.params.indel_kmer_len
        if self._v2tab is None:
            self._v2tab = V2Tables.from_tables(self.tables, self.device)
        null_lls = [self._null_ll(y) for y in reads]
        # per read: its jobs (ny, nx, env) and packed width
        per_read = {}  # ny -> (width, jobs)
        for ny, y in enumerate(reads):
            if not sort_order[ny]:
                continue
            y_index, envs = self._envelopes(refs, y, sort_order[ny])
            jobs, width = [], 1
            for nx in sort_order[ny]:
                env = envs[nx]
                wp = sum(s.band_width for s in pack_strips(env))
                if self.config.sparse and wp > ESTEP_LANE_CAP:
                    env = fit_envelope_lanes(
                        refs[nx], y_index, ESTEP_LANE_CAP,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                    wp = sum(s.band_width for s in pack_strips(env))
                if wp == 0:
                    continue  # an empty envelope: forward score -inf
                jobs.append((ny, nx, env))
                width = max(width, wp)
            if jobs:
                per_read[ny] = (width, jobs)
        chunk_reads, oversize = estep_chunk_plan(
            [(ny, len(reads[ny].seq), w,
              [len(refs[nx].seq) for _, nx, _ in js])
             for ny, (w, js) in per_read.items()],
            self._pair_bytes,
            lane_cap=ESTEP_LANE_CAP if self.config.sparse else None)

        n_jobs = sum(len(per_read[ny][1]) for c in chunk_reads for ny in c)
        total = QuaffParamCounts.zero(mk, ik)
        xy_ll = {}
        n_done = 0
        for nys in chunk_reads:
            chunk = [job for ny in nys for job in per_read[ny][1]]
            width = max(per_read[ny][0] for ny in nys)
            group_of, gid, null_g = {}, [], []
            for ny, _, _ in chunk:
                if ny not in group_of:
                    group_of[ny] = len(null_g)
                    null_g.append(null_lls[ny])
                gid.append(group_of[ny])
            batch = PairBatch.build_packed(
                [(refs[nx], reads[ny], env) for ny, nx, env in chunk],
                self.tables, width=width,
            )
            fwd, _, totals = estep_fused_multi(
                self._v2tab, to_device(batch, self.device),
                np.asarray(gid, np.int32), np.asarray(null_g, np.float64),
                local=self.config.local,
            )
            total.add_weighted(
                QuaffParamCounts.from_counts(_pair_counts(totals, None, mk, ik)),
                1.0)
            for (ny, nx, _), f in zip(chunk, fwd):
                xy_ll[(ny, nx)] = float(f)
            n_done += len(chunk)
            if plog is not None:
                plog.log_progress(n_done / max(n_jobs, 1),
                                  f"{n_done}/{n_jobs} pair fills")

        oversize_results = {
            ny: self.count_read(refs, reads[ny], sort_order[ny],
                                force_engine=True)
            for ny in oversize
        }
        # per-read statistics in host float64 (the kernels' float32 y_ll
        # only shapes the count weights)
        loglike = 0.0
        new_orders: List[List[int]] = []
        for ny in range(len(reads)):
            if ny in oversize_results:
                y_counts, y_ll, order = oversize_results[ny]
                total.add_weighted(y_counts, 1.0)
                loglike += y_ll
                new_orders.append(order)
                continue
            y_loglike = null_lls[ny]
            xy = np.full(len(refs), -math.inf)
            for nx in sort_order[ny]:
                xy[nx] = xy_ll.get((ny, nx), -math.inf)
                y_loglike = _log_sum_exp(y_loglike, xy[nx])
            loglike += y_loglike
            new_orders.append(_ref_order(xy, y_loglike))
        return total, loglike, new_orders


@dataclass
class QuaffTrainer:
    """The EM loop (QuaffTrainer::fit, qmodel.cpp:2169-2231)."""

    max_iterations: int = MAX_EM_ITERATIONS
    min_fractional_loglike_increment: float = MIN_EM_LOGLIKE_INC
    max_read_bases: int = 0
    allow_null_model: bool = True
    save_params_filename: str = ""
    raw_counts_filename: str = ""
    counts_with_prior_filename: str = ""
    checkpoint_dir: str = ""  # preemption-safe EM state checkpointing

    def effective_reads(self, reads: List[FastSeq]) -> List[FastSeq]:
        """-maxreadmb training-set truncation (qmodel.cpp:2169-2183)."""
        if self.max_read_bases <= 0:
            return reads
        limited = []
        bases = 0
        for y in reads:
            limited.append(y)
            bases += len(y.seq)
            if bases >= self.max_read_bases:
                break
        return limited

    def fit(
        self,
        refs: List[FastSeq],
        reads: List[FastSeq],
        seed: QuaffParams,
        null_model: QuaffNullParams,
        pseudocounts: QuaffParamCounts,
        config: DPConfig,
        log=lambda *a: None,
    ) -> QuaffParams:
        reads = self.effective_reads(reads)
        assert pseudocounts.match_kmer_len == seed.match_kmer_len
        assert pseudocounts.indel_kmer_len == seed.indel_kmer_len

        qp = seed
        prev_ll_with_prior = -math.inf
        sort_order = [list(range(len(refs))) for _ in reads]
        start_iter = 0
        if self.checkpoint_dir:
            from .checkpoint import TrainState, load_checkpoint, save_checkpoint

            ckpt = load_checkpoint(self.checkpoint_dir)
            if ckpt is not None and len(ckpt.sort_order) == len(reads):
                qp = ckpt.params
                prev_ll_with_prior = ckpt.prev_loglike_with_prior
                sort_order = ckpt.sort_order
                start_iter = ckpt.iteration
                log(f"Resuming from checkpoint at EM iteration {start_iter}")
        for it in range(start_iter, self.max_iterations):
            counter = QuaffCounter(qp, null_model, config,
                                   self.allow_null_model)
            counts, loglike, sort_order = counter.get_counts(refs, reads,
                                                             sort_order)
            if self.raw_counts_filename:
                with open(self.raw_counts_filename, "w") as f:
                    counts.write_json(f)
                    f.write("\n")
            log_prior = pseudocounts.log_prior(qp)
            ll_with_prior = loglike + log_prior
            log(
                f"EM iteration {it + 1}: log-likelihood ({loglike:g}) + "
                f"log-prior ({log_prior:g}) = {ll_with_prior:g}"
            )
            if it > 0 and ll_with_prior < prev_ll_with_prior + abs(
                prev_ll_with_prior
            ) * self.min_fractional_loglike_increment:
                break
            prev_ll_with_prior = ll_with_prior

            counts_with_prior = QuaffParamCounts.zero(
                qp.match_kmer_len, qp.indel_kmer_len
            )
            counts_with_prior.add_weighted(counts, 1.0)
            counts_with_prior.add_weighted(pseudocounts, 1.0)
            if self.counts_with_prior_filename:
                with open(self.counts_with_prior_filename, "w") as f:
                    counts_with_prior.write_json(f)
                    f.write("\n")

            qp = counts_with_prior.fit()
            qp.fit_ref_seqs(refs)

            if self.save_params_filename:
                with open(self.save_params_filename, "w") as f:
                    qp.write_json(f)
                    f.write("\n")
            if self.checkpoint_dir:
                save_checkpoint(
                    self.checkpoint_dir,
                    TrainState(
                        params=qp,
                        iteration=it + 1,
                        prev_loglike_with_prior=prev_ll_with_prior,
                        sort_order=sort_order,
                    ),
                )
        return qp
