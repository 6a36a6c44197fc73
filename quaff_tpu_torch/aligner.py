"""The `quaff align` pipeline on PyTorch: banded Viterbi scoring of every
(ref, read) pair on the device, winner refill and traceback on the host.

Ported from quaff_tpu/aligner.py.  Every candidate pair is scored by K1
(dp/fill_v2.scores_v2) on `config.device`: the CUDA kernel on a card, its
plain PyTorch version on the CPU.  The winners are then refilled in
float64 on the host by the port's native library and walked back, so the
text output is decided in float64 exactly as in the JAX package; the
float32 scores only choose the winners.

Not ported here: the device mesh (-mesh), remote, qsub and ssh/EC2
backends (the CLI refuses them), and the JAX package's TPU workarounds
(the cold-kernel native gates, the wide-envelope host fallback and the
VMEM-derived batch caps: chunks are sized from the card's memory).
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import IO, List, Optional

import numpy as np
import torch

from .envelope import (
    DEFAULT_BAND_SIZE,
    DEFAULT_KMER_LENGTH,
    DEFAULT_KMER_THRESHOLD,
    Envelope,
    fit_envelope_lanes,
    make_envelope,
    pack_strips,
)
from .formats.alignment import Alignment, AlignmentPrinter
from .io.fastseq import FastSeq, KmerIndex
from .logger import ProgressLogger, logger
from .model.params import QuaffNullParams, QuaffParams
from .native import align_fill_native, align_score_native

from .device import resolve_device
from .dp.engine import PairBatch, to_device
from .dp.fill_v2 import V2Tables, batch_max_prop, scores_v2
from .dp.scores import ScoreTables
from .dp.traceback import viterbi_path_traceback, viterbi_traceback

# DP storage cost per cell used for the memory-fitted envelope threshold:
# 3 doubles for Viterbi (reference qmodel.h:384)
VITERBI_CELL_SIZE = 24

# Long-band guard: a pair whose packed width exceeds this many lanes is
# re-banded with the memory-fitted walk (fit_envelope_lanes, the
# reference's diagenv.cpp:60-106).  On long noisy reads the fixed seed
# threshold admits spurious clusters scattered over the whole diagonal
# range; the walk keeps the winning paths and drops the noise lanes.
ALIGN_LANE_CAP = 4096

# Scoring chunks: at most this many pairs, and at most B*W lanes within
# a budget of device memory.  BYTES_PER_LANE covers the float32 [B, W]
# temporaries of K1's plain version (the kernel itself needs less: its
# inputs plus, for bands too wide for shared memory, 24 bytes of scratch).
MAX_BATCH = 2048
BYTES_PER_LANE = 64
CPU_CHUNK_BYTES = 1 << 30

# Per-strip float64 refill scope: only strips whose float32 kernel score
# is within this margin (nats) of the pair's best strip are refilled for
# the winner traceback (kernel error on these fills is about 1e-3 nats,
# so the true float64-best strip is always in scope).
STRIP_MARGIN = 1.0


@dataclass
class DPConfig:
    """Execution configuration: the banding and DP-mode subset of the
    reference's QuaffDPConfig (qmodel.h:280-352) that quaff_tpu's DPConfig
    keeps, plus the torch device."""

    local: bool = True
    sparse: bool = True
    kmer_len: int = DEFAULT_KMER_LENGTH
    kmer_threshold: int = DEFAULT_KMER_THRESHOLD
    band_size: int = DEFAULT_BAND_SIZE
    max_size: int = 0
    auto_mem_size: bool = False
    threads: int = 1
    # torch device for K1 scoring; None -> $QUAFF_TORCH_DEVICE or "cuda"
    device: Optional[str] = None

    def effective_max_size(self) -> int:
        return self.max_size // self.threads if self.auto_mem_size else self.max_size

    def make_envelope(self, x: FastSeq, y_index: KmerIndex, cell_size: int) -> Envelope:
        return make_envelope(
            x,
            y_index,
            sparse=self.sparse,
            band_size=self.band_size,
            kmer_threshold=self.kmer_threshold,
            cell_size=cell_size,
            max_size=self.effective_max_size(),
        )


class QuaffAligner:
    """Viterbi alignment of reads against references.

    All (ref, read) band scores run as batched K1 calls on the device; the
    winners' bands are refilled and walked back on the host in float64.
    """

    def __init__(
        self,
        params: QuaffParams,
        null_model: QuaffNullParams,
        config: DPConfig,
        print_all: bool = False,
    ):
        self.params = params
        self.null_model = null_model
        self.config = config
        self.print_all = print_all
        self.device = resolve_device(config.device)
        self.tables = ScoreTables.from_params(params)
        self.v2tab = V2Tables.from_tables(self.tables, self.device)

    def align_read(self, refs: List[FastSeq], y: FastSeq) -> List[Alignment]:
        """Align one read against all refs; returns the best alignment (or
        all finite ones if print_all), null-model-adjusted, sorted by
        descending score (ties keep reference order)."""
        y_index = KmerIndex(y, self.config.kmer_len)
        envs = [
            self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE) for x in refs
        ]
        # lane-packed strips: multi-cluster envelopes cost their member
        # lanes, not their bounding band
        kbatch = PairBatch.build_packed(
            [(x, y, e) for x, e in zip(refs, envs)], self.tables
        )
        scores = scores_v2(
            self.v2tab, to_device(kbatch, self.device), mode="viterbi",
            local=self.config.local, max_prop=batch_max_prop(kbatch),
        )
        null_ll = self.null_model.log_likelihood(y)

        if self.print_all:
            picks = [nx for nx in range(len(refs)) if math.isfinite(scores[nx])]
        else:
            best: Optional[int] = None
            for nx in range(len(refs)):
                if math.isfinite(scores[nx]) and (
                    best is None or scores[nx] > scores[best]
                ):
                    best = nx
            picks = [] if best is None else [best]
        if not picks:
            return []

        # winners only: float64 banded fill with matrices on the host
        wbatch = PairBatch.build(
            [(refs[nx], y, envs[nx]) for nx in picks], self.tables
        )
        res = align_fill_native(wbatch, self.tables, mode="viterbi",
                                local=self.config.local)
        out: List[Alignment] = []
        for i, nx in enumerate(picks):
            score = float(res["score"][i])
            if logger.logging_tag("dpmatrix"):
                # `-log dpmatrix` cell dump (QuaffViterbiMatrix,
                # qmodel.cpp:1558-1559)
                from .dp.debug import write_dp_matrix

                write_dp_matrix(
                    refs[nx], y, envs[nx],
                    res["mat"][i], res["ins"][i], res["del"][i], score,
                )
            a = viterbi_traceback(
                refs[nx], y, envs[nx], self.tables,
                res["mat"][i], res["ins"][i], res["del"][i], score,
                local=self.config.local,
            )
            a.score -= null_ll
            out.append(a)
        out.sort(key=lambda a: -a.score)
        return out

    def align_all(
        self,
        out: IO[str],
        refs: List[FastSeq],
        reads: List[FastSeq],
        printer: AlignmentPrinter,
    ) -> None:
        """The `quaff align` pipeline: header, then per-read best alignments
        in read order (qmodel.cpp:2624-2646).  Several reads are scored in
        cross-read device batches; only the winning pairs are refilled
        with matrices for traceback."""
        plog = ProgressLogger(level=2)
        plog.init_progress("Alignment")
        printer.write_header(out, refs, group_by_query=True)
        if len(reads) <= 1:
            for y in reads:
                for a in self.align_read(refs, y):
                    printer.write_alignment(out, a)
            plog.done()
            return
        per_read = self._align_batched(refs, reads, plog)
        for ny in range(len(reads)):
            for a in per_read.get(ny, []):
                printer.write_alignment(out, a)
        plog.done()

    def _chunk_lane_cap(self) -> int:
        """Most B*W lanes one scoring chunk may hold: an eighth of the
        card's memory, or CPU_CHUNK_BYTES on the host."""
        if self.device.type == "cuda":
            budget = torch.cuda.get_device_properties(self.device).total_memory // 8
        else:
            budget = CPU_CHUNK_BYTES
        return budget // BYTES_PER_LANE

    def _align_batched(self, refs, reads, plog, max_batch: int = MAX_BATCH):
        def round_up(v, m):
            return ((v + m - 1) // m) * m

        # phase A: envelopes for every (read, ref) pair, parallel over
        # reads with -threads N (read-major order is kept)
        def _read_jobs(ny):
            y_index = KmerIndex(reads[ny], self.config.kmer_len)
            js = []
            for nx, x in enumerate(refs):
                env = self.config.make_envelope(x, y_index, VITERBI_CELL_SIZE)
                if self.config.sparse and (
                    sum(s.band_width for s in pack_strips(env)) > ALIGN_LANE_CAP
                ):
                    env = fit_envelope_lanes(
                        x, y_index, ALIGN_LANE_CAP,
                        band_size=self.config.band_size,
                        kmer_threshold=max(self.config.kmer_threshold, 0),
                    )
                js.append((ny, nx, env))
            return js

        jobs = []  # (ny, nx, env)
        from concurrent.futures import ThreadPoolExecutor

        if self.config.threads > 1 and len(reads) > 1:
            with ThreadPoolExecutor(self.config.threads) as ex:
                for js in ex.map(_read_jobs, range(len(reads))):
                    jobs.extend(js)
        else:
            for ny in range(len(reads)):
                jobs.extend(_read_jobs(ny))

        def kernel_width(env):
            return sum(s.band_width for s in pack_strips(env))

        # phase B chunking: greedy row-merged chunks (longest reads first)
        # per quality-presence group; a chunk merges mixed read lengths
        # until the padding waste would exceed one extra full row scan,
        # and stops at max_batch pairs or the lane budget.
        groups: dict = {}
        for job in jobs:
            groups.setdefault(reads[job[0]].has_qual(), []).append(job)
        lane_cap = self._chunk_lane_cap()

        chunks = []
        for hq, js in sorted(groups.items()):
            js.sort(key=lambda j: -len(reads[j[0]].seq))
            i = 0
            while i < len(js):
                lp = round_up(len(reads[js[i][0]].seq), 512)
                chunk = [js[i]]
                wmax = kernel_width(js[i][2])
                i += 1
                waste = 0
                while i < len(js) and len(chunk) < max_batch:
                    w_j = lp - round_up(len(reads[js[i][0]].seq), 512)
                    wm = max(wmax, kernel_width(js[i][2]))
                    if waste + w_j > lp or (len(chunk) + 1) * wm > lane_cap:
                        break
                    waste += w_j
                    wmax = wm
                    chunk.append(js[i])
                    i += 1
                chunks.append(chunk)

        scores = {}  # (ny, nx) -> (score, env, per-strip kernel scores)
        n_done = 0
        remaining = [0] * len(reads)  # unscored pairs per read
        for ny, nx, env in jobs:
            remaining[ny] += 1

        # ---- phase C machinery: winner strip fills + tracebacks ----
        # Runs concurrently with phase B: as each scored chunk drains,
        # reads whose pairs are all scored emit winner jobs; jobs gather
        # into footprint-capped fill chunks submitted to a worker pool
        # (the native float64 fill and traceback release the GIL).  Every
        # result carries a (read, candidate-rank) tag and results merge in
        # tag order, so the output bytes do not depend on thread timing
        # or chunk grouping.
        from collections import deque

        null_cache = {}
        null_lock = threading.Lock()

        def null_ll(ny):
            v = null_cache.get(ny)
            if v is None:
                v = self.null_model.log_likelihood(reads[ny])
                with null_lock:
                    null_cache[ny] = v
            return v

        # one checkpointed native call per winner (fill + walk fused, no DP
        # matrices)
        T = max(1, self.config.threads)

        def fill_and_walk(chunk):
            """One worker unit: resolve each winner's best strip in float64
            and walk its traceback.  chunk: [(seq, ny, nx, strips)]."""
            out = []
            for seq, ny, nx, strips in chunk:
                if len(strips) > 1:
                    # matrix-free score fills pick the float64-best strip
                    # (the first strict maximum)
                    wb = PairBatch.build(
                        [(refs[nx], reads[ny], s) for s in strips],
                        self.tables,
                    )
                    sc = align_score_native(
                        wb, self.tables, mode="viterbi",
                        local=self.config.local, threads=1,
                    )
                    strip = strips[int(np.argmax(sc))]
                else:
                    strip = strips[0]
                a = viterbi_path_traceback(
                    refs[nx], reads[ny], strip, self.tables,
                    local=self.config.local,
                )
                a.score -= null_ll(ny)
                out.append((seq, ny, a))
            return out

        # a worker unit holds winners up to a padded DP area (strips x rows
        # x width), so units carry similar work; in-flight futures are
        # windowed to T+1 units.
        max_elems = 6_000_000
        pool = ThreadPoolExecutor(T)
        futures = deque()
        collected = []  # (seq, ny, alignment)
        cbuf = []
        cb_strips = cb_w = cb_r = 0

        def flush():
            nonlocal cbuf, cb_strips, cb_w, cb_r
            if not cbuf:
                return
            chunk, cbuf = cbuf, []
            cb_strips = cb_w = cb_r = 0
            while len(futures) > T:
                collected.extend(futures.popleft().result())
            futures.append(pool.submit(fill_and_walk, chunk))

        def add_winner(seq, ny, nx, env, segs):
            nonlocal cb_strips, cb_w, cb_r
            strips = pack_strips(env, 3)
            if len(strips) > 1:
                best = max(float(v) for v in segs[: len(strips)])
                strips = [
                    s for k, s in enumerate(strips)
                    if float(segs[k]) >= best - STRIP_MARGIN
                ]
            w_j = max(s.band_width for s in strips)
            r_j = len(reads[ny].seq) + 1
            padded = (
                (cb_strips + len(strips)) * max(cb_r, r_j) * max(cb_w, w_j)
            )
            if cbuf and padded > max_elems:
                flush()
            cbuf.append((seq, ny, nx, strips))
            cb_strips += len(strips)
            cb_w = max(cb_w, w_j)
            cb_r = max(cb_r, r_j)

        def emit_read(ny):
            """All of read ny's pairs are scored: queue its winner(s)."""
            cands = [
                (nx,) + scores[(ny, nx)] for nx in range(len(refs))
                if math.isfinite(scores[(ny, nx)][0])
            ]
            if not cands:
                return
            if self.print_all:
                for rank, (nx, sc, env, segs) in enumerate(cands):
                    add_winner((ny, rank), ny, nx, env, segs)
            else:
                best_nx, best_sc, best_env, best_segs = cands[0]
                for nx, sc, env, segs in cands[1:]:
                    if sc > best_sc:
                        best_nx, best_sc, best_env, best_segs = (
                            nx, sc, env, segs
                        )
                add_winner((ny, 0), ny, best_nx, best_env, best_segs)

        def record_chunk(chunk, s, segs):
            nonlocal n_done
            for i, (ny, nx, env) in enumerate(chunk):
                scores[(ny, nx)] = (float(s[i]), env, segs[i])
                remaining[ny] -= 1
                if remaining[ny] == 0:
                    emit_read(ny)
            n_done += len(chunk)
            plog.log_progress(
                n_done / len(jobs), f"{n_done}/{len(jobs)} pairs scored"
            )

        # ---- phase B: enqueue chunks ahead and fetch in order, so the
        # device fills chunk i+1 while the host walks chunk i's winners
        inflight = deque()  # (chunk, unfetched device scores, n_segs)
        max_inflight = 4

        def drain_one():
            chunk, dev, n_segs = inflight.popleft()
            packed = dev.cpu().numpy().astype(np.float64)
            B = len(chunk)
            record_chunk(chunk, packed[:B], packed[B:].reshape(B, n_segs))

        try:
            for chunk in chunks:
                batch = PairBatch.build_packed(
                    [(refs[nx], reads[ny], env) for ny, nx, env in chunk],
                    self.tables,
                )
                dev = scores_v2(
                    self.v2tab, to_device(batch, self.device), mode="viterbi",
                    local=self.config.local, return_segments=True,
                    defer_fetch=True, max_prop=batch_max_prop(batch),
                )
                inflight.append((chunk, dev, batch.seg_d_lo.shape[1]))
                if len(inflight) >= max_inflight:
                    drain_one()
            while inflight:
                drain_one()

            flush()
            while futures:
                collected.extend(futures.popleft().result())
        finally:
            pool.shutdown()

        # merge in (read, candidate-rank) tag order: byte-identical to the
        # sequential read-major walk regardless of thread timing
        collected.sort(key=lambda t: t[0])
        per_read: dict = {}
        for seq, ny, a in collected:
            per_read.setdefault(ny, []).append(a)
        for ny in per_read:
            per_read[ny].sort(key=lambda a: -a.score)
        return per_read
