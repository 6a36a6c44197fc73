"""Sharded E-step and scoring over ranks: reads over dp, references over mp.

Ported from quaff_tpu/parallel/estep.py, with one rank a device
(parallel/distributed.py) in place of shard_map over a device mesh.  Each
rank runs the single-card code on its own share: K1 (dp/fill_v2), K4
(dp/ov_fill), K2 + K3 with the count reduction (dp/estep), or the exact
engine (dp/counts), on its own device.  Results come back to every rank
by all_gather in rank order (distributed.gather_floats); sums are taken
in rank order on every rank, never by all_reduce, so every rank holds the
same bits and the ranks' EM steps cannot drift apart.

The JAX functions and their counterparts here:

  sharded_align_kernel, sharded_overlap_kernel,
  sharded_align_engine, sharded_viterbi_scores
                        -> sharded_scores: the rank's chunks through the
                           caller's single-card scorer (scores_v2, whose
                           kernel is band_fill; overlap_scores, whose
                           kernel is ov_fill; or the engine's dp_fill)
  gather_scores         -> gather_scores
  sharded_estep_kernel  -> sharded_estep_kernel: the rank's reads through
                           trainer.QuaffCounter (estep_fused_multi on a
                           card, the exact engine on the CPU)
  sharded_estep         -> sharded_estep: the E-step of a (read, ref)
                           grid whose refs are split over the mp ranks,
                           the read's log-likelihood a log-sum-exp over
                           the mp group (_lse_over_axis)
  build_pair_grid, MeshCountsProvider -> the same names

As in the JAX package, every (read, ref) pair of an -meshmp run is
counted with its exact posterior weight (the reference's Delta=20 skip
becomes a negligible weight).  With mp = 1 each rank runs the sequential
E-step, skip included, on its own reads.
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..dp.engine import PairBatch, to_device
from ..io.fastseq import FastSeq
from ..model.params import QuaffParamCounts
from .distributed import (GlobalMesh, gather_floats, host_read_shard,
                          rank_device, sum_in_rank_order)

# null log-likelihood of a sentinel read: its posterior weights are 0
SENTINEL_NULL_LL = 1e30


def build_pair_grid(refs, reads, tables, config, cell_size: int
                    ) -> Tuple[dict, np.ndarray]:
    """Host assembly of the [R, K] pair grid: every (read, ref) pair's
    bounding-band arrays (to_device's keys, on the CPU) with leading dims
    [R, K], and the reads' lengths."""
    from ..io.fastseq import KmerIndex

    R, K = len(reads), len(refs)
    pairs = []
    for y in reads:
        y_index = KmerIndex(y, config.kmer_len)
        for x in refs:
            pairs.append((x, y, config.make_envelope(x, y_index, cell_size)))
    flat = to_device(PairBatch.build(pairs, tables), "cpu")
    grid = {k: v.reshape((R, K) + tuple(v.shape[1:])) for k, v in flat.items()}
    return grid, np.array([len(y.seq) for y in reads])


def gather_scores(local: Dict[int, np.ndarray], group=None
                  ) -> Dict[int, np.ndarray]:
    """Every rank's {chunk: float64 scores} merged on every rank (the JAX
    gather_scores' allgather across processes); group None is the world."""
    parts = []
    for i, v in sorted(local.items()):
        v = np.asarray(v, np.float64).reshape(-1)
        parts += [np.asarray([i, v.size], np.float64), v]
    flat = np.concatenate(parts) if parts else np.zeros(0)
    out = {}
    for vec in gather_floats(flat, group):
        o = 0
        while o < vec.size:
            i, n = int(vec[o]), int(vec[o + 1])
            out[i] = vec[o + 2 : o + 2 + n]
            o += 2 + n
    return out


def sharded_scores(mesh: GlobalMesh, n_chunks: int,
                   score_chunk: Callable[[int], torch.Tensor]
                   ) -> List[np.ndarray]:
    """Score n_chunks chunks over the ranks: chunk i on rank i % size
    (GlobalMesh.chunks_of_rank), through score_chunk(i), the single-card
    scorer's unfetched tensor of float32 scores; then every chunk's
    scores, float64, on every rank, in chunk order.  A rank enqueues all
    its chunks before it fetches the first."""
    pending = [(i, score_chunk(i)) for i in mesh.chunks_of_rank(n_chunks)]
    local = {i: t.cpu().numpy().astype(np.float64) for i, t in pending}
    got = gather_scores(local)
    return [got[i] for i in range(n_chunks)]


# ---------------------------------------------------------------------------
# the E-step


def counts_vector(c: QuaffParamCounts) -> np.ndarray:
    """QuaffParamCounts as one float64 vector (counts_from_vector's)."""
    return np.concatenate([
        c.insert.reshape(-1), c.match.reshape(-1), c.begin_insert_no,
        c.begin_insert_yes, c.begin_delete_no, c.begin_delete_yes,
        [c.extend_insert_no, c.extend_insert_yes, c.extend_delete_no,
         c.extend_delete_yes],
    ]).astype(np.float64)


def counts_from_vector(v: np.ndarray, mk: int, ik: int) -> QuaffParamCounts:
    out = QuaffParamCounts.zero(mk, ik)
    o = 0

    def take(shape):
        nonlocal o
        n = int(np.prod(shape))
        a = np.array(v[o : o + n], np.float64).reshape(shape)
        o += n
        return a

    out.insert = take(out.insert.shape)
    out.match = take(out.match.shape)
    ki = out.begin_insert_no.shape
    out.begin_insert_no, out.begin_insert_yes = take(ki), take(ki)
    out.begin_delete_no, out.begin_delete_yes = take(ki), take(ki)
    (out.extend_insert_no, out.extend_insert_yes, out.extend_delete_no,
     out.extend_delete_yes) = (float(x) for x in take((4,)))
    return out


def _reduce(mesh: GlobalMesh, counts: QuaffParamCounts, lls, orders,
            real: List[bool]):
    """One all_gather over the world: each rank's count totals, the sum of
    its real reads' log-likelihoods and their sort orders.  Counts come
    from every rank; the log-likelihoods and orders from the first rank
    of each dp row only (its mp peers hold the same).  Returns (counts,
    loglike, orders of every real read in read order), the same on every
    rank: the sums run in rank order in float64."""
    loglike = 0.0
    enc: List[float] = []
    if mesh.mp_index == 0:
        for keep, v, order in zip(real, lls, orders):
            if keep:
                loglike += v
                enc += [len(order)] + list(order)
    vec = counts_vector(counts)
    E = vec.size
    parts = gather_floats(np.concatenate([vec, [loglike], enc]))
    total = sum_in_rank_order([p[: E + 1] for p in parts])
    all_orders = []
    for p in parts:
        o = E + 1
        while o < p.size:
            n = int(p[o])
            all_orders.append([int(v) for v in p[o + 1 : o + 1 + n]])
            o += 1 + n
    return (counts_from_vector(total[:E], counts.match_kmer_len,
                               counts.indel_kmer_len),
            float(total[E]), all_orders)


def sharded_estep_kernel(mesh: GlobalMesh, counter, refs, reads, orders,
                         real: List[bool]):
    """The E-step of this rank's reads against every ref, through the
    single-card E-step (counter.count_reads: K2, K3 and the reduction for
    reads with qualities on a card, the exact engine otherwise), then the
    totals summed over the ranks in rank order: (counts, loglike, orders)
    of every real read, on every rank.  `real` marks this rank's reads
    that are not sentinels."""
    counts, lls, new_orders = counter.count_reads(refs, reads, orders)
    return _reduce(mesh, counts, lls, new_orders, real)


def sharded_estep(mesh: GlobalMesh, counter, refs, ref_ids: List[int],
                  n_refs: int, reads, real: List[bool]):
    """The E-step when refs are split over the mp ranks (-meshmp): this
    rank holds refs[k] for global ids ref_ids.  A read's weights need
    every ref, so the E-step splits where the single-card code splits it:

      1. the forward score of each (read, own ref) pair: K2 alone
         (dp/estep._fwd) over estep_chunk_plan's chunks on a card, the
         exact engine (forward and counts at once) for the others;
      2. the scores all_gathered over the mp group, and each pair's weight
         exp(fwd - y_ll) formed in float64, y_ll the log-sum-exp of the
         read's null model and all its refs (_lse_over_axis);
      3. the counts with those weights: dp/estep.estep_kernel (K2 + K3 and
         the reduction) on each chunk, the engine's counts scaled on the
         host.

    Then the totals as sharded_estep_kernel's."""
    from ..dp.estep import _fwd, estep_kernel
    from ..dp.fill_v2 import kernel_inputs
    from ..trainer import (
        ESTEP_LANE_CAP, _log_sum_exp, _pair_counts, _ref_order,
        estep_chunk_plan,
    )

    mk, ik = counter.params.match_kmer_len, counter.params.indel_kmer_len
    R, K = len(reads), len(refs)
    envs = counter.envelopes or [None] * R
    for r, y in enumerate(reads):
        envs[r] = counter._envelopes(refs, y, range(K), envs[r])
    fwd = np.full((R, K), -math.inf)
    kern_reads = [r for r, y in enumerate(reads) if counter._use_kernel(y)]
    chunks, oversize = [], []
    if kern_reads:
        from ..dp.fill_v2 import V2Tables
        from ..envelope import pack_strips

        v2tab = V2Tables.from_tables(counter.tables, counter.device)
        jobs = {}
        for r in kern_reads:
            js = [(r, k, envs[r][1][k]) for k in range(K)]
            js = [j for j in js
                  if sum(s.band_width for s in pack_strips(j[2])) > 0]
            if js:
                jobs[r] = js
        plan, oversize = estep_chunk_plan(
            [(r, len(reads[r].seq),
              max(sum(s.band_width for s in pack_strips(e)) for _, _, e in js),
              [len(refs[k].seq) for _, k, _ in js])
             for r, js in jobs.items()],
            counter._pair_bytes,
            lane_cap=ESTEP_LANE_CAP if counter.config.sparse else None)
        for rs in plan:
            chunk = [j for r in rs for j in jobs[r]]
            batch = to_device(PairBatch.build_packed(
                [(refs[k], reads[r], e) for r, k, e in chunk],
                counter.tables), counter.device)
            f = _fwd(v2tab, kernel_inputs(batch), counter.config.local,
                     None)[0].cpu().numpy().astype(np.float64)
            for (r, k, _), v in zip(chunk, f):
                fwd[r, k] = v
            chunks.append((chunk, batch, f))
    engine = {}  # r -> per-pair engine results against the rank's refs
    for r, y in enumerate(reads):
        if r in kern_reads and r not in oversize:
            continue
        res = counter._engine(PairBatch.build(
            [(refs[k], y, envs[r][0][k]) for k in range(K)], counter.tables),
            False)
        fwd[r] = np.asarray(res["fwd_score"], np.float64)
        engine[r] = res

    # 2. every ref's forward score of this rank's reads, in ref-id order
    blocks = gather_floats(fwd.reshape(-1), mesh.mp_group)
    all_fwd = np.full((R, n_refs), -math.inf)
    kpp = K
    for j, b in enumerate(blocks):
        all_fwd[:, j * kpp : (j + 1) * kpp] = b.reshape(R, kpp)
    y_ll = np.empty(R)
    for r, y in enumerate(reads):
        acc = counter._null_ll(y)
        for v in all_fwd[r]:
            acc = _log_sum_exp(acc, v)
        y_ll[r] = acc
    weight = np.where(np.isfinite(fwd), np.exp(fwd - y_ll[:, None]), 0.0)

    # 3. the weighted counts
    total = QuaffParamCounts.zero(mk, ik)
    for chunk, batch, f in chunks:
        w = np.asarray([weight[r, k] for r, k, _ in chunk])
        _, c = estep_kernel(v2tab, batch, w, f, local=counter.config.local)
        total.add_weighted(
            QuaffParamCounts.from_counts(_pair_counts(c, None, mk, ik)), 1.0)
    for r, res in engine.items():
        for k in range(K):
            if weight[r, k] > 0:
                total.add_weighted(QuaffParamCounts.from_counts(
                    _pair_counts(res, k, mk, ik)), float(weight[r, k]))
    orders = [_ref_order(all_fwd[r], y_ll[r]) for r in range(R)]
    return _reduce(mesh, total, list(y_ll), orders, real)


class _SentinelNull:
    """The null model of a rank's reads: the run's for real reads (-inf
    under -force), SENTINEL_NULL_LL for the sentinel reads that pad the
    read list to a multiple of dp, so that their posterior weights are
    exactly 0."""

    def __init__(self, null_model, allow_null: bool, sentinels):
        self.null_model = null_model
        self.allow_null = allow_null
        self.sentinels = {id(y) for y in sentinels}

    def log_likelihood(self, y) -> float:
        if id(y) in self.sentinels:
            return SENTINEL_NULL_LL
        return (self.null_model.log_likelihood(y) if self.allow_null
                else -math.inf)


class MeshCountsProvider:
    """The mesh E-step for QuaffTrainer.fit(counts_provider=): the
    counterpart of farming each EM iteration's counting to workers
    (qmodel.cpp:2034-2120), with reads over the dp ranks and refs over
    the mp ranks.

    Reads are padded to a multiple of dp with sentinel reads (__pad{i},
    "ACGT") whose null log-likelihood is SENTINEL_NULL_LL, so their
    weights are exactly 0, and whose log-likelihood is left out of the
    total.  Each rank builds the envelopes of its own block of reads
    against its own refs once (trainer.read_envelopes, which drops each
    read's KmerIndex); each iteration then runs the single-card E-step
    on them (sharded_estep_kernel, or sharded_estep under -meshmp), and
    every rank gets the same totals, log-likelihood and sort orders."""

    def __init__(self, mesh: GlobalMesh, refs, reads, seed_params,
                 null_model, config, allow_null: bool = True,
                 dtype=torch.float64):
        from ..trainer import QuaffCounter, read_envelopes

        if len(refs) % mesh.mp:
            raise ValueError(
                f"number of references ({len(refs)}) must divide the mesh "
                f"mp axis ({mesh.mp}); use -meshmp 1 to replicate refs")
        self.mesh = mesh
        self.refs = refs
        self.n_reads = len(reads)
        self.dtype = dtype
        self.config = replace(config, device=str(rank_device(config.device)))
        pad = (-len(reads)) % mesh.dp
        sentinels = [FastSeq(name=f"__pad{i}", seq="ACGT", qual="IIII")
                     for i in range(pad)]
        padded = list(reads) + sentinels
        self.reads = host_read_shard(padded, mesh.dp_index, mesh.dp)
        lo = mesh.dp_index * len(self.reads)
        self.block = range(lo, lo + len(self.reads))
        self.real = [i < len(reads) for i in self.block]
        kpp = len(refs) // mesh.mp
        self.ref_ids = list(range(mesh.mp_index * kpp,
                                  (mesh.mp_index + 1) * kpp))
        self.local_refs = [refs[k] for k in self.ref_ids]
        self.null = _SentinelNull(null_model, allow_null, sentinels)
        probe = QuaffCounter(seed_params, self.null, self.config,
                             dtype=dtype)
        self.envelopes = [
            read_envelopes(self.config, self.local_refs, y,
                           range(len(self.local_refs)),
                           kernel=probe._use_kernel(y))
            for y in self.reads
        ]

    def __call__(self, qp, sort_order):
        from ..trainer import QuaffCounter

        counter = QuaffCounter(qp, self.null, self.config,
                               use_null_model=True, dtype=self.dtype,
                               envelopes=list(self.envelopes))
        if self.mesh.mp == 1:
            orders = [sort_order[i] if i < self.n_reads
                      else list(range(len(self.refs))) for i in self.block]
            counts, loglike, orders = sharded_estep_kernel(
                self.mesh, counter, self.local_refs, self.reads, orders,
                self.real)
        else:
            counts, loglike, orders = sharded_estep(
                self.mesh, counter, self.local_refs, self.ref_ids,
                len(self.refs), self.reads, self.real)
        return counts, loglike, orders[: self.n_reads]
