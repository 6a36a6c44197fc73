#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (quaff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

It builds everything from the checkout and runs its phases in order; any
failure exits non-zero before the final line is printed.

  0  the card's name and power limit (nvidia-smi), torch and CUDA versions
  1  build the kernels (quaff_tpu_torch/csrc/*.cu: K1's warp, cluster and
     block routes, K2, K3, the count reduction, K4's warp and cluster
     routes and the probes' chain kernel;
     one nvcc per source, sm_90a; ptxas's registers and spills a kernel)
     and the host library libquaffio (native/*.cpp, one g++ per source),
     both at once
  2  K1 against its plain PyTorch version on the card: c8f30 against itself
     lane-packed at B=2048 (the align configuration; the warp route), plus
     forward, global (the cluster route), no-quality, gap-order-1 and a
     band wider than the block route's shared memory (the cluster route);
     every launch must take fill_route's route; on the two cluster-route
     cases the block route forced on the same inputs, held against the
     plain version, and every other cluster tiling timed alike, each
     one's error logged against the plain version and against it in
     float64 (the float32 drift's witness); median times, in-envelope
     cells/s, the least time the card could take
  2b K2, K3 and the count reduction against their plain versions: B=64
     W~134 Ly=300 at gap order 0 and 1, global mode, a 257-512-lane batch
     (the warp routes' cutover: lanes-a-thread 16 against the block
     route), a band wider than shared memory, and the c8f30 self pair;
     each of K2's and K3's routes (the warp route where 512 lanes cover the
     band, the block route) forced on the same inputs, K3 on each route's
     K2 store, each against the plain versions and repeated bit for bit,
     timed (CUDA events, median of 3); the reduction bit for bit; two runs
     must give bit-identical count tables; the reduction and torch.sum
     timed alike (device time from a CUDA graph of 100 calls, the eager
     100 back to back, one call with host launch)
  2c K4 against its plain version: 64 overlapping pairs of 2-10 kb reads,
     lane-packed (up to 3 strips), at gap order 0 and 1, each batch with
     both strands and reads with and without qualities; the plain version
     on 8 of them (per strand, the two multi-strip pairs of reads with
     qualities and the two of reads without that have the fewest rows);
     times, in-envelope cells/s, the bound.  Per gap order two batches: the
     64 widest pairs (7211 lanes: the cluster route) and the 64 widest
     pairs that the warp route takes, on the warp route and on the cluster
     route forced on the same inputs
  2d the speed-of-light probes (quaff_tpu_torch/prof/, the chain kernel
     csrc/sol_probe.cu): each of its five ops against its plain version at
     [2048, 256] over 128 steps (add_max and roll_add bitwise, the lse
     chains within rtol 1e-6 / atol 1e-5); then roofline_probe (add+max
     and roll+add chains at [256, 256] and [2048, 256], K1's fill rate at
     B = 512-4096, K1's cost per row) and sol_transcendental (the lse
     chains in add_max steps, the element check) as a user runs them
  3  the port's `align` CLI on cuda, byte for byte against four goldens,
     with K1 launched in each run
  3b `train` on c8f30 (2 EM iterations) through K2/K3 against the golden
     log-likelihoods and c8f30-train2.oracle.json; `count -fast` on
     synth12 against the float64 parity count, with the default k-mer band
     and with -kmatchband 600 (wider than any warp route: the K2/K3 block
     routes' path); each chunk's routes, held to estep_route's; then
     K2/K3 (the block routes) and the reduction on the -kmatchband 600
     run's chunk against their plain versions
  3c the port's `overlap` CLI on cuda, byte for byte against five goldens,
     with K4's launches (K4 must run on the multi-pair ones)
  4  align at a size users run: a seeded 200 kb genome and 512 reads of
     2-10 kb (12% substitutions and indels, half reverse strand, with
     qualities) through the CLI on cuda; reads/s, K1 launches by route and
     width and each route's share of the in-envelope cells, K1's device
     time by route and the device's busy share (torch.profiler); each
     warp-route chunk with the cluster route forced on the same inputs;
     the first 32 reads again on the CPU (plain version) must give the
     same text; then the cluster route on the run's largest cluster-route
     chunk against its plain version, the block route forced beside it
     and every other cluster tiling timed alike, with the errors of
     phase 2's cluster-route cases
  4b `align -kmatchoff` (no k-mer envelope, so bands wider than the
     cluster route's widest): a seeded 20 kb genome and 4 reads of 2-3 kb
     through the CLI on cuda, every K1 launch on the block route, which is
     then held against its plain version on the run's chunk
  5  train at a size users run: 128 such reads, `train -maxiter 2` through
     the CLI on cuda; s per EM iteration, pair fills, K2/K3 launches by
     route, each chunk's (B, W, routes, K2 and K3 device ms) from the
     profiler's kernel names, peak device memory; the log-likelihood must
     rise; `count -fast` on all 128 reads twice, the second time while a
     tensor holds most of the card's free memory, byte for byte the same
     (the E-step's chunk plan reads no free memory); `count -fast` on the
     first 8 reads against the parity count; then K2/K3 (both routes
     forced) and the reduction on the run's largest chunk against their
     plain versions
  6  overlap at a size users run: 64 reads of 2-10 kb from a seeded 100 kb
     genome (phase 4's recipe), all-vs-all with reverse complements (6048
     pairs) through the CLI on cuda; wall, pairs/s, K4 launches by route
     (each chunk on ov_route's route, the warp route launched) and each
     route's share of the in-envelope cells, each chunk's (B, W, route,
     device ms), where the host time goes and the device's busy share; the
     first 32 reads' text must equal the port's sequential float64 route
     (no kernel pruning) on the same reads, and the first 8 reads' run on
     the CPU (plain K4, in a process of its own beside the reference) the
     GPU's; each warp-route chunk with the cluster route forced on the
     same inputs, and each cluster-route chunk at every tiling it can
     take; then K4 on the run's largest chunk (the warp route, and the
     cluster route forced on the same inputs) against its plain version
     (its first 128 pairs), on the largest cluster-route chunk (the plain
     version on its last 4 pairs), and, where the run has a chunk of
     OV_WARP_MAX_LANES + 1 to twice as many lanes, the warp route forced on
     it against the cluster route (the warp route's cutover)
  7  `server` and its backends: (a) the port's `server align` in a thread
     of this process on cuda, and `align -remote` against it through the
     CLI on 128 of phase 4's reads against a 12 kb genome (an align job
     refills the winner's whole envelope in float64, as the JAX package's
     does: on phase 4's 200 kb genome that is gigabytes a read, logged),
     byte for byte the local align; K1's launches by the server's jobs (at
     least one a read, each on fill_route's route by the profiler's
     kernel names), requests/s, the median and p90 request, K1's device
     time; the jobs' K1 launches at the widest band, the most rows and on
     each route taken against the plain version, rerun bit for bit; (b)
     the same with two ports and two client workers, the same blocks in
     reply order; (c) `server count` and `count -remote` on phase 5's
     first read against its genome window, against the plain float64
     count of the read without qualities (a count worker loads reads
     so), and the exact engine's launches a row on the card
     (torch.profiler); (d) `server overlap` and `overlap -remote` on
     phase 6's first 8 reads, byte for byte the local overlap; (e) an
     ssh-launched worker (stub ssh) and qsub through /bin/sh, 2 reads
     each, (a)'s text; (f) `align -profile`, whose Chrome trace must name
     K1's kernels

Phases 4 and 5 run at a cut depth (512 and 128 reads) to keep the script
well inside its time limit.  Each plain version's comparison run is also
one of its timed runs.  Each kernel case of phases 2, 2c, 4, 4b, 6 and 7 also
reruns the kernel on the same inputs and requires the same bits.

Each path (phase 4 for K1's warp and cluster routes, phase 4b's align
-kmatchoff for its block route, phase 5 for K2's and K3's warp routes and
the reduction, phase 3b's wide-band count -fast for their block routes,
phase 6 for K4's two routes, the probes' run in phase 2d for the chain
kernel, phase 7's `align -remote` runs for K1 on the server's path) runs
with the launch counts set to 0 just before it and read just after.
The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
DATA = ROOT / "tests" / "data"
RTOL, ATOL = 1e-5, 1e-3  # K1's parity tolerance (tests/test_pallas_v2.py)
# K4 against its plain version: both are float32 over up to 10^4 rows, and
# on phase-2c pairs the float32 plain version was measured up to 0.026 off a
# float64 run of itself (on a CPU), so the two may differ by ~0.05; 0.05 is
# also the JAX package's K4 tolerance against its float64 fill
# (tests/test_pallas_overlap.py:86), and under the pipeline's 0.25-nat strip
# and 1-nat pair slacks
OV_RTOL, OV_ATOL = 1e-5, 0.05
# phase 6 holds the text of the first N_REF reads' all-vs-all against the
# sequential float64 route: all 64 reads took 276.6 s on an H100 host, over
# the 120 s this phase may spend on it
N_REF = 32


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg=""):
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 0


def phase0_card():
    import torch

    from quaff_tpu_torch.prof.chains import card_label

    card = card_label()
    log(card)
    log(f"phase 0: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return card


# ---------------------------------------------------------------- phase 1


def phase1_build():
    """The CUDA kernels (one nvcc per source) and the host library (one g++
    per source) build at the same time; a failed build raises."""
    from concurrent.futures import ThreadPoolExecutor

    from quaff_tpu_torch import kernels, native

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(2) as ex:
        t_cuda = ex.submit(timed, kernels.library)
        t_host = ex.submit(timed, native.get_lib)
        t_cuda, t_host = t_cuda.result(), t_host.result()
    how = "built" if kernels.build_log is not None else "reused"
    log(f"phase 1: kernel library (K1's warp, cluster and block routes, K2, "
        f"K3, reduce, K4's warp and cluster routes, P1/P2 chains) {how} in "
        f"{t_cuda:.1f} s "
        f"({kernels.library_path().relative_to(ROOT)})")
    from quaff_tpu_torch.prof.kernel_sass import demangle, parse_ptxas

    ptxas = parse_ptxas(kernels.build_log or "")
    names = demangle(ptxas)
    for fn, (regs, st, ld) in sorted(ptxas.items(), key=lambda kv: names[kv[0]]):
        log(f"  ptxas: {names[fn]}: {regs} registers, {st} bytes spill "
            f"stores, {ld} bytes spill loads")
    how = "built" if native.build_log is not None else "reused"
    log(f"phase 1: host libquaffio {how} from native/*.cpp in {t_host:.1f} s "
        f"({native.library_path().relative_to(ROOT)})")


# ---------------------------------------------------------------- phase 2


def _synthetic_pairs(rng, n, with_qual=True):
    """Reads matching two copies of a repeat in their ref: multi-strip
    envelopes (the lane-packed layout with halo seams)."""
    from quaff_tpu_torch.envelope import sparse_envelope
    from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex

    pairs = []
    for b in range(n):
        core = "".join("ACGT"[t] for t in rng.integers(0, 4, 300))
        spacer = "".join("ACGT"[t] for t in rng.integers(0, 4, 200))
        ys = list(core)
        for i in range(len(ys)):
            if rng.random() < 0.06:
                ys[i] = "ACGT"[int(rng.integers(0, 4))]
        qual = ("".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(ys)))
                if with_qual else "")
        x = FastSeq(name=f"x{b}", seq=core + spacer + core)
        y = FastSeq(name=f"y{b}", seq="".join(ys), qual=qual)
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=64,
                              kmer_threshold=10)
        pairs.append((x, y, env))
    return pairs


def _errors(got, ref, rtol=RTOL, atol=ATOL):
    """(max |got - ref| over finite entries, whether every entry is within
    rtol / atol of ref); fails where the two disagree on which scores are
    -inf."""
    import torch

    floor = -3.4028234663852886e38 / 2
    g = torch.where(got <= floor, float("-inf"), got).double().cpu()
    r = torch.where(ref <= floor, float("-inf"), ref).double().cpu()
    check(torch.equal(torch.isfinite(g), torch.isfinite(r)),
          "kernel and plain version disagree on which scores are -inf")
    fin = torch.isfinite(r)
    check(bool(fin.any()), "no finite score to compare")
    err = (g[fin] - r[fin]).abs()
    return float(err.max()), not bool((err > atol + rtol * r[fin].abs()).any())


def _compare(got, ref, rtol=RTOL, atol=ATOL):
    """max |kernel - plain| over finite entries; fails outside tolerance."""
    err, ok = _errors(got, ref, rtol, atol)
    check(ok, f"kernel vs plain outside rtol {rtol} / atol {atol}: max abs "
              f"err {err:.3g}")
    return err


def _timed(fn, v):
    """(fn(v), its seconds) by CUDA events around the call (a plain
    version's host-side launch gaps count too)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    res = fn(v)
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end) / 1e3


def _times(fn, variants):
    return [_timed(fn, v)[1] for v in variants]


def _back_to_back(fn, arg, n=100):
    """(eager, graph) seconds a call of fn(arg) over n back-to-back calls
    on the same input, after a warm call, by CUDA events around the n:
    eager as the host enqueues them (the host's rate where a call takes it
    longer to enqueue than the card to run), and the same n calls captured
    in one CUDA graph and replayed, which leaves the device's own time."""
    import torch

    fn(arg)  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn(arg)
    end.record()
    torch.cuda.synchronize()
    eager = start.elapsed_time(end) / 1e3 / n
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn(arg)
    graph.replay()  # warm
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return eager, start.elapsed_time(end) / 1e3 / n


def _time(fn, variants):
    """Median seconds of fn(v) over distinct inputs."""
    return statistics.median(_times(fn, variants))


def _sweep_tilings(W, lpts, max_warps):
    """The cluster tilings (CTAs a pair, warps a CTA, lanes a thread) a
    band of W lanes can take: for each lanes-a-thread whose tiles (at most
    32) cover it, the fewest CTAs of at most 4, 8 and 16 warps (as the
    kernel allows), spread evenly, up to 8 CTAs.  Timed beside the route
    table's pick on the cluster-route chunks of the paths: the
    measurement the tables (fill_v2.FILL_CLUSTER_TABLE,
    ov_fill.OV_CLUSTER_TABLE) are set from."""
    out = []
    for lpt in lpts:
        tiles = -(-W // (32 * lpt))
        for cap in (4, 8, 16):
            nct = -(-tiles // cap)
            t = (nct, -(-tiles // nct), lpt)
            if (tiles <= 32 and cap <= max_warps(lpt) and nct <= 8
                    and t not in out):
                out.append(t)
    return out


# H100 SXM peaks (NVIDIA's data sheet, dense, at its 700 W limit): float32
# outside the tensor cores, and HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# float32 operations per in-envelope cell, counted from each kernel's cell
# update (a log-add-exp counts 6: max, subtract, abs, exp, log1p, add)
OPS_PER_CELL = {"viterbi": 13, "forward": 33, "fwd_store": 39,
                "bwd_counts": 106}


def _bound(nbytes, ops):
    """(least ms the card could take, what bounds it): bytes over the HBM
    rate or operations over the float32 rate, whichever is larger."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FP32
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def _cells_on_device(inp):
    """In-envelope cells of a kernel_inputs batch, as a tensor on its
    device (no wait): for each lane, the rows j = 1..ylen whose ref index
    doff + j - 1 lies in [0, xlen)."""
    import torch

    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    d = inp["doff"].long()
    Ly = inp["keys"].shape[1]
    xlen = inp["meta"][:, 0:1].long()
    ylen = inp["meta"][:, 1:2].long().clamp(max=Ly)
    n = torch.minimum(ylen, xlen - d) - torch.clamp(1 - d, min=1) + 1
    return torch.where(inp["doff"] != D_SENTINEL, n.clamp(min=0), 0).sum()


def _cells(inp):
    return int(_cells_on_device(inp))


def _ref_window(inp):
    """Ref tokens a batch's fills read: for each pair, the union over its
    lanes of the ref indices doff + j - 1, j = 1..ylen, inside [0, xlen)."""
    import torch

    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    d = torch.sort(inp["doff"].long(), dim=1).values  # sentinel lanes last
    xlen, ylen = inp["meta"][:, 0:1].long(), inp["meta"][:, 1:2].long()
    lo = d.clamp(min=0)
    hi = torch.minimum(d + ylen - 1, xlen - 1)
    # hi rises with the diagonal: a lane's window can overlap only the
    # windows of the lanes before it, whose union ends at the previous hi
    prev = torch.cat([torch.full_like(hi[:, :1], -1), hi[:, :-1]], dim=1)
    n = hi - torch.maximum(lo, prev + 1) + 1
    return int(torch.where(d != D_SENTINEL, n.clamp(min=0), 0).sum())


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _table_bytes(v2):
    return _nbytes(v2.match, v2.match_noq, v2.insert, v2.insert_noq, v2.ik,
                   v2.trans)


def _fill_in_bytes(inp, v2):
    """Bytes of a fill's inputs that this batch needs, each read once: the
    ref tokens of the band windows (int8), the key rows up to each read's
    length, meta, every lane's diagonal, the strip descriptors and the
    tables."""
    Ly = inp["keys"].shape[1]
    rows = int(inp["meta"][:, 1].clamp(max=Ly).sum())
    return (_ref_window(inp) + 16 * rows
            + _nbytes(inp["meta"], inp["doff"], inp["seg_start"],
                      inp["seg_width"]) + _table_bytes(v2))


def _key_variants(keys, n):
    """n copies of K1's keys, each with one quality value changed: distinct
    inputs for timed runs."""
    out = []
    for i in range(n):
        k = keys.clone()
        k[:, i % k.shape[1], 1] = (k[:, i % k.shape[1], 1] + 1) % 40
        out.append(k)
    return out


def run_case(name, pb, tables, mode, local, card, n_runs=3, route=None,
             also=()):
    """K1 and its plain version on one batch: agreement and times."""
    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.dp.engine import to_device

    v2 = fill_v2.V2Tables.from_tables(tables, "cuda")
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    return fill_case(f"phase 2: {name}", inp, v2, mode, local, card, n_runs,
                     route, fill_v2.batch_max_prop(pb), also=also)


FILL_COUNTS = ("launches", "warp_launches", "cluster_launches",
               "block_launches")


def _route_counts():
    from quaff_tpu_torch.dp import fill_v2

    return {k: getattr(fill_v2.band_fill, k) for k in FILL_COUNTS}


def _route_label(route):
    """A route as the logs name it: the warp route with its lanes a
    thread, the cluster route with its tiling (CTAs a pair x warps a CTA x
    lanes a thread), the block route."""
    kind, arg = route
    if kind == "warp":
        return f"warp route, {arg} lanes a thread"
    if kind == "cluster":
        return "cluster route, {} x {} x {}".format(*arg)
    return "block route"


def fill_case(name, inp, v2, mode, local, card, n_runs=3, route=None,
              mp=None, n_plain=None, also=()):
    """K1 and its plain version on kernel_inputs `inp`: agreement, a rerun
    bit for bit, times, and that every launch took fill_route's route
    (`route`, when given, must be its kind).  Each route of `also` is forced on the same inputs,
    held against the plain version and timed alike; on the cluster route
    every other tiling of _sweep_tilings is timed alike, and every route
    and tiling's error is logged against the plain version and against it
    in float64 (the float32 drift's witness), a swept tiling's without
    failing (only the route table's tiling is held to the tolerance).
    Returns the result of fill_route's route, with "also" {label: ms} and,
    on the cluster route, "sweep" {label: (ms, error against the plain
    version, error against float64, within tolerance)}."""
    import torch

    from quaff_tpu_torch.dp import fill_v2

    W = inp["doff"].shape[1]
    want = fill_v2.fill_route(W)
    check(route is None or want[0] == route,
          f"{name}: W={W} takes the {want[0]} route, not the {route} route")
    before = _route_counts()

    def kern(keys, r=None):
        return fill_v2.band_fill(**dict(inp, keys=keys), tables=v2, mode=mode,
                                 local=local, route=r)

    def plain(keys, dtype=torch.float32):
        return fill_v2.band_fill_reference(**dict(inp, keys=keys), tables=v2,
                                           mode=mode, local=local, max_prop=mp,
                                           dtype=dtype)

    got = kern(inp["keys"])
    check(torch.equal(kern(inp["keys"]), got),
          f"{name}: a rerun of K1 on the same inputs is not bit-identical")
    ref, t_ref = _timed(plain, inp["keys"])
    err = _compare(got, ref)
    variants = _key_variants(inp["keys"], n_runs + 1)
    kern(variants[0])  # warm
    ms = _time(kern, variants[1:]) * 1e3
    moved = {k: v - before[k] for k, v in _route_counts().items()}
    check(moved == {"launches": n_runs + 3,
                    **{f"{r}_launches": (n_runs + 3) * (want[0] == r)
                       for r in ("warp", "cluster", "block")}},
          f"{name}: K1's launches by route {moved}, want all {n_runs + 3} "
          f"on the {want[0]} route")
    # the plain version: the comparison's run and n_plain - 1 more
    n_plain = n_runs if n_plain is None else n_plain
    plain_ms = statistics.median(
        [t_ref] + _times(plain, variants[1:n_plain])) * 1e3
    B = inp["doff"].shape[0]
    cells = _cells(inp)
    bound_ms, bound_by = _bound(
        _fill_in_bytes(inp, v2) + 4 * B * (1 + inp["seg_start"].shape[1]),
        OPS_PER_CELL[mode] * cells)
    log(f"{name}: B={B} W={W} Ly={inp['keys'].shape[1]} {mode} "
        f"{'local' if local else 'global'} ({_route_label(want)}): max abs "
        f"err {err:.3g}; K1 {ms:.3f} ms (median of {n_runs}), plain "
        f"{plain_ms:.3f} ms (median of {n_plain}); "
        f"{cells} in-envelope cells, {cells / (ms / 1e3):.4g} cells/s, "
        f"bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    # the plain version in float64 where the band is a cluster route's:
    # how far each float32 fill drifts, so which side an error comes from
    wit = plain(inp["keys"], torch.float64) if want[0] == "cluster" else None
    if wit is not None:
        log(f"{name}: against the plain version in float64: the plain "
            f"version {_errors(ref, wit)[0]:.3g}, {_route_label(want)} "
            f"{_errors(got, wit)[0]:.3g}")
    others = {}
    for r in also:
        out = kern(inp["keys"], r)
        e = _compare(out, ref)
        kern(variants[0], r)  # warm
        others[_route_label(r)] = _time(lambda k: kern(k, r),
                                        variants[1:]) * 1e3
        e64 = "" if wit is None else (
            f", {_errors(out, wit)[0]:.3g} against it in float64")
        log(f"{name}: {_route_label(r)} forced on the same inputs: "
            f"{others[_route_label(r)]:.3f} ms (median of {n_runs}), max abs "
            f"err {e:.3g} against the plain version{e64} [{card}]")
    sweep = {}
    if wit is not None:
        # the other tilings, timed alike, each one's error logged (the card
        # tests hold every tiling against the plain version on their own
        # inputs)
        for t in _sweep_tilings(W, fill_v2.FILL_CLUSTER_LPTS,
                                fill_v2.fill_cluster_max_warps):
            if t == want[1]:
                continue
            r = ("cluster", t)
            out = kern(inp["keys"], r)
            e32, ok = _errors(out, ref)
            kern(variants[0], r)  # warm
            sweep[_route_label(r)] = (
                _time(lambda k: kern(k, r), variants[1:]) * 1e3, e32,
                _errors(out, wit)[0], ok)
        log(f"{name}: each other tiling on the same inputs (ms, median of "
            f"{n_runs}; max abs err against the plain version / against it "
            f"in float64): " + "; ".join(
                "{}: {:.3f} ({:.3g} / {:.3g}{})".format(
                    k.removeprefix("cluster route, "), ms, e32, e64,
                    "" if ok else f", outside rtol {RTOL} / atol {ATOL}")
                for k, (ms, e32, e64, ok) in sweep.items()) + f" [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "cells": cells,
            "route": want, "also": others, "sweep": sweep}


def phase2_kernel(card):
    import numpy as np
    import torch

    from quaff_tpu_torch import kernels
    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.envelope import full_envelope, make_envelope
    from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex, read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffParams, default_params
    from quaff_tpu_torch.dp.engine import PairBatch
    from quaff_tpu_torch.dp.scores import ScoreTables

    tables = ScoreTables.from_params(default_params())
    # the align configuration: c8f30 against itself, lane-packed, B=2048
    y = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x.qual = ""
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=14, cell_size=24)
    B = 2048
    pb = PairBatch.build_packed([(x, y, env)] * B, tables)
    main = run_case("c8f30 packed", pb, tables, "viterbi", True, card,
                    route="warp")
    cells = main["cells"]
    log(f"phase 2: c8f30 packed: K1 {cells / (main['ms'] / 1e3):.4g} cells/s, "
        f"plain {cells / (main['plain_ms'] / 1e3):.4g} cells/s [{card}]")

    rng = np.random.default_rng(7)
    pairs = _synthetic_pairs(rng, 64)
    run_case("forward", PairBatch.build_packed(pairs, tables), tables,
             "forward", True, card)
    # global paths need the whole ref in the band: full envelopes (W above
    # 1024 lanes: the cluster route; the block route forced beside it)
    run_case("global", PairBatch.build(
        [(xg, yg, full_envelope(len(xg.seq), len(yg.seq)))
         for xg, yg, _ in pairs[:16]], tables), tables, "viterbi", False, card,
        route="cluster", also=(("block", 0),))
    run_case("no-qual", PairBatch.build_packed(
        _synthetic_pairs(rng, 64, with_qual=False), tables), tables,
        "viterbi", True, card)
    gap1 = ScoreTables.from_params(QuaffParams.from_json(
        (DATA / "params-gaporder1.json").read_text()))
    run_case("gaporder1", PairBatch.build_packed(pairs, gap1), gap1,
             "viterbi", True, card)
    # a band wider than the block route's shared memory (its row state in
    # global scratch) and narrower than the cluster route's widest: the
    # cluster route, the block route forced beside it
    limit = kernels.max_smem_lanes(torch.cuda.current_device())
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, limit + 2000))
    wide = []
    for b in range(8):
        s0 = int(rng.integers(0, len(xs) - 400))
        yw = FastSeq(name=f"w{b}", seq=xs[s0:s0 + 400],
                     qual="".join(chr(33 + int(q))
                                  for q in rng.integers(3, 40, 400)))
        wide.append((FastSeq(name="xw", seq=xs), yw,
                     full_envelope(len(xs), 400)))
    wpb = PairBatch.build(wide, tables)
    check(limit < wpb.member.shape[1] <= fill_v2.FILL_CLUSTER_MAX_LANES,
          "the wide case fits shared memory, or no cluster route takes it")
    run_case(f"wide (W > {limit} smem lanes)", wpb, tables, "viterbi", True,
             card, route="cluster", also=(("block", 0),))
    return main


# ---------------------------------------------------------------- phase 3


def _cli(argv, device, stderr=False):
    """The port's CLI in-process on `device`; returns its stdout (and, with
    stderr=True, what it wrote to stderr)."""
    from quaff_tpu_torch.cli import main

    saved = os.environ.get("QUAFF_TORCH_DEVICE")
    os.environ["QUAFF_TORCH_DEVICE"] = device
    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(argv)
    finally:
        if saved is None:
            del os.environ["QUAFF_TORCH_DEVICE"]
        else:
            os.environ["QUAFF_TORCH_DEVICE"] = saved
    check(rc == 0, f"{' '.join(argv)} exited {rc}: {err.getvalue()[-2000:]}")
    return (out.getvalue(), err.getvalue()) if stderr else out.getvalue()


def phase3_goldens():
    from quaff_tpu_torch.dp import fill_v2

    runs = [
        ("synth12", ["synth12-genome.fasta", "synth12.fastq", "-kmatchn",
                     "10", "-nothreshold"], "synth12-align.oracle.stk"),
        ("c8f30 self", ["c8f30.fastq.gz", "c8f30.fastq.gz", "-kmatchmb", "10",
                        "-fwdstrand"], "c8f30-self-align.json"),
        ("multiref", ["multiref.fasta", "c8f30.fastq.gz", "-kmatchmb", "10",
                      "-fwdstrand"], "multiref-align.oracle.txt"),
        ("revref", ["revref.fasta", "c8f30.fastq.gz", "-kmatchmb", "10"],
         "revref-align.oracle.txt"),
    ]
    for name, args, golden in runs:
        argv = ["align"] + [str(DATA / a) if (DATA / a).exists() else a
                            for a in args]
        before = fill_v2.band_fill.launches
        t0 = time.perf_counter()
        out = _cli(argv, "cuda")
        dt = time.perf_counter() - t0
        n = fill_v2.band_fill.launches - before
        check(n > 0, f"{name}: K1 was not launched")
        check(out == (DATA / golden).read_text(),
              f"{name}: output differs from {golden}")
        log(f"phase 3: {name}: byte-identical to {golden}; {n} K1 launches; "
            f"{dt:.2f} s")


# ---------------------------------------------------------------- phase 4


def _workload(tmp, seed=1, genome_len=200_000, n_reads=1024,
              min_len=2000, max_len=10_000, err=0.12, n_head=32):
    """A genome and noisy reads from a fixed seed: each position of a read
    is substituted, followed by an inserted base, or deleted with
    probabilities 0.6*err, 0.2*err and 0.2*err; half the reads are reverse
    complemented; qualities are drawn from the quality values of the
    repository's nanopore read (c8f30), which the default model fits."""
    import numpy as np

    from quaff_tpu_torch.io.fastseq import read_fast_seqs

    rng = np.random.default_rng(seed)
    quals = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0].qual_scores()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    gpath = tmp / "genome.fasta"
    gpath.write_text(">genome\n" + acgt[genome].tobytes().decode() + "\n")
    recs, origins = [], []
    for i in range(n_reads):
        n = int(rng.integers(min_len, max_len + 1))
        s0 = int(rng.integers(0, genome_len - n))
        origins.append((s0, n, bool(i % 2)))
        t = genome[s0:s0 + n].copy()
        r = rng.random(n)
        sub = r < 0.6 * err
        t[sub] = (t[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        ins = (r >= 0.6 * err) & (r < 0.8 * err)
        dele = (r >= 0.8 * err) & (r < err)
        pos = np.nonzero(ins)[0] + 1
        t = np.insert(t, pos, rng.integers(0, 4, len(pos)).astype(np.int8))
        keep = np.ones(len(t), bool)
        keep[np.nonzero(dele)[0] + np.searchsorted(pos, np.nonzero(dele)[0],
                                                   side="right")] = False
        t = t[keep]
        if i % 2:
            t = (3 - t)[::-1]
        q = rng.choice(quals, len(t))
        recs.append(f"@read{i}\n{acgt[t].tobytes().decode()}\n+\n"
                    f"{(q + 33).astype(np.uint8).tobytes().decode()}\n")
    rpath = tmp / "reads.fastq"
    rpath.write_text("".join(recs))
    head = tmp / f"reads{n_head}.fastq"
    head.write_text("".join(recs[:n_head]))
    return gpath, rpath, head, genome, origins


def _fill_time(kw, route, n_runs=3):
    """Median ms of K1 on `route` over n_runs distinct inputs of a recorded
    band_fill call, after a warm run."""
    from quaff_tpu_torch.dp import fill_v2

    def kern(keys):
        return fill_v2.band_fill(**dict(kw, keys=keys), route=route)

    vs = _key_variants(kw["keys"], n_runs + 1)
    kern(vs[0])
    return _time(kern, vs[1:]) * 1e3


def phase4_workload(card, n_reads=512, genome_len=200_000, n_check=32):
    from torch.profiler import ProfilerActivity, profile

    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.dp.fill_v2 import cluster_tiling
    from quaff_tpu_torch.io.fastseq import read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffNullParams
    from quaff_tpu_torch.prof.kernel_sass import kernel_of

    threads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        t0 = time.perf_counter()
        gpath, rpath, head, _, _ = _workload(tmp, n_reads=n_reads,
                                       genome_len=genome_len)
        log(f"phase 4: {n_reads} reads, {genome_len} bp genome generated in "
            f"{time.perf_counter() - t0:.1f} s")
        # the null model is fitted to all reads once and both runs load it
        # (-null), so the check run scores the first reads alike
        null = tmp / "null.json"
        with open(null, "w") as f:
            QuaffNullParams.fit(read_fast_seqs(str(rpath))).write_json(f)
        argv = ["align", str(gpath), str(rpath), "-threads", threads,
                "-null", str(null)]
        # each K1 launch's route, width and in-envelope cells; the inputs
        # of the largest cluster-route chunk are kept for its timed run
        calls = _record_fill()
        with calls, profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = _cli(argv, "cuda")
            wall = time.perf_counter() - t0
        counts = calls.counts
        check(counts["launches"] > 0, "the main path launched no K1")
        n_aligned = out.count("#=GF Score")
        check(n_aligned >= 0.9 * n_reads,
              f"only {n_aligned} of {n_reads} reads aligned")
        log(f"phase 4: align on cuda: {wall:.2f} s wall, "
            f"{n_reads / wall:.2f} reads/s, {n_aligned} alignments, "
            f"{counts['launches']} K1 launches [{card}]")
        # K1's device time by route from the kernels' names, and the
        # device's busy share
        events = _kernel_events(prof, "band_fill")
        check(len(events) == counts["launches"],
              f"phase 4: {len(events)} K1 kernels traced, {counts}")
        by_route = {}
        for (kname, ms), (r, _, _, _) in zip(events, calls.calls):
            check(kernel_of(kname) == ("band_fill", r[0]),
                  f"phase 4: a chunk on fill_route's {r} ran {kname}")
            by_route[r[0]] = by_route.get(r[0], 0.0) + ms
        busy = sum(_device_busy(prof).values())
        log(f"phase 4: K1 device ms by route {by_route}; torch.profiler: "
            f"device busy {busy:.3f} s of {wall:.3f} s wall "
            f"({100 * busy / wall:.2f}%) [{card}]")
        cells = {r: sum(int(c) for rr, _, _, c in calls.calls if rr[0] == r)
                 for r in ("warp", "cluster", "block")}
        total = max(sum(cells.values()), 1)
        for r in ("warp", "cluster", "block"):
            ws = sorted(W for rr, W, _, _ in calls.calls if rr[0] == r)
            check(len(ws) == counts[f"{r}_launches"],
                  f"phase 4: {len(ws)} {r}-route chunks but "
                  f"{counts[f'{r}_launches']} {r}-route launches")
            log(f"phase 4: K1 {r} route: {len(ws)} launches at W {ws}, "
                f"{cells[r]} in-envelope cells "
                f"({100 * cells[r] / total:.2f}% of the run's)")
        log("phase 4: K1 launches (route, W, B): "
            + ", ".join(f"({_route_label(r)}, {W}, {B})"
                        for r, W, B, _ in calls.calls))
        # each warp-route chunk with the cluster route forced on the same
        # inputs (the warp route's cutover, at the sizes align launches)
        both = []
        for kw, (r, W, B, _) in zip(calls.inputs, calls.calls):
            if r[0] == "warp":
                forced = ("cluster", cluster_tiling(
                    W, fill_v2.FILL_CLUSTER_TABLE))
                both.append((B, W, r[1], forced[1],
                             _fill_time(kw, r), _fill_time(kw, forced)))
        log("phase 4: warp-route chunks on both routes (B, W, lanes a "
            "thread, cluster tiling, warp ms, cluster ms): " + "; ".join(
                "({}, {}, {}, {} x {} x {}, {:.3f}, {:.3f})".format(
                    B, W, lpt, *t, w, c) for B, W, lpt, t, w, c in both)
            + f"; all {len(both)}: {sum(b[4] for b in both):.3f} against "
            f"{sum(b[5] for b in both):.3f} ms [{card}]")
        del calls.inputs
        t0 = time.perf_counter()
        cpu = _cli(["align", str(gpath), str(head), "-threads", threads,
                    "-null", str(null)], "cpu")
        check(cpu.count("#=GF Score") >= 0.9 * n_check,
              "CPU check run aligned too few reads")
        check(out.startswith(cpu),
              f"first {n_check} reads: CPU (plain version) text differs from "
              "the GPU run's")
        log(f"phase 4: first {n_check} reads on the CPU (plain version): "
            f"byte-identical to the GPU run ({time.perf_counter() - t0:.1f} s)")
    return counts, calls.widest.get("cluster")


class _record_fill:
    """While active (a with block), each K1 launch's (route, W, B,
    in-envelope cells) in .calls and its inputs in .inputs, the inputs of
    each route's largest chunk (B * W * Ly) in .widest, and the launches by
    route, counted from 0, in .counts."""

    def __init__(self):
        self.calls, self.inputs, self.widest, self.counts = [], [], {}, {}
        self._size = {}

    def __enter__(self):
        from quaff_tpu_torch.dp import fill_v2

        self.orig = orig = fill_v2.band_fill

        def recording(**kw):
            res = orig(**kw)
            B, W = kw["doff"].shape
            route = fill_v2.fill_route(W)
            self.calls.append((route, W, B, _cells_on_device(kw)))
            self.inputs.append(kw)
            size = B * W * kw["keys"].shape[1]
            if size > self._size.get(route[0], 0):
                self._size[route[0]] = size
                self.widest[route[0]] = kw
            return res

        # band_fill adds its launches to the counts of the module's
        # `band_fill`, which is `recording` while it is installed
        for k in FILL_COUNTS:
            setattr(recording, k, 0)
        self.recording = recording
        fill_v2.band_fill = recording
        return self

    def __exit__(self, *exc):
        from quaff_tpu_torch.dp import fill_v2

        fill_v2.band_fill = self.orig
        self.counts = {k: getattr(self.recording, k) for k in FILL_COUNTS}
        return False


def phase4b_kmatchoff(card, genome_len=20_000, n_reads=4):
    """`align -kmatchoff` (no k-mer envelope: every pair's band spans its
    whole ref and read, wider than the cluster route's widest): K1's block
    route's path.  A seeded 20 kb genome and 4 reads of 2-3 kb through the
    CLI on cuda; every launch must take the block route; then the block
    route on the run's chunk against its plain version (once)."""
    from quaff_tpu_torch.dp import fill_v2

    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        gpath, rpath, _, _, _ = _workload(tmp, seed=9, n_reads=n_reads,
                                          genome_len=genome_len,
                                          min_len=2000, max_len=3000,
                                          n_head=1)
        calls = _record_fill()
        with calls:
            t0 = time.perf_counter()
            out = _cli(["align", str(gpath), str(rpath), "-kmatchoff",
                        "-nothreshold"], "cuda")
            wall = time.perf_counter() - t0
        counts = calls.counts
        check(counts["launches"] > 0
              and counts["block_launches"] == counts["launches"],
              f"phase 4b: K1 launches by route {counts}, want all on the "
              f"block route")
        check(out.count("#=GF Score") == n_reads,
              f"phase 4b: {out.count('#=GF Score')} of {n_reads} reads "
              "aligned")
        log(f"phase 4b: align -kmatchoff on cuda: {wall:.2f} s wall, "
            f"{n_reads} alignments, K1 launches (route, W, B): "
            + ", ".join(f"({_route_label(r)}, {W}, {B})"
                        for r, W, B, _ in calls.calls) + f" [{card}]")
        kw = calls.widest["block"]
    res = fill_case("phase 4b: the -kmatchoff chunk",
                    {k: kw[k] for k in ("x_tok", "keys", "meta", "doff",
                                        "seg_start", "seg_width")},
                    kw["tables"], kw["mode"], kw["local"], card,
                    route="block", mp=kw["max_prop"], n_plain=1)
    return counts, res


# ---------------------------------------------------------------- phase 2b

C_RTOL, C_ATOL = 3e-3, 5e-3  # counts (tests/test_pallas_counts.py:63,78)


def _compare_counts(got, ref):
    """max |kernel - plain| of count tables; fails outside tolerance."""
    import torch

    g, r = got.double().cpu(), ref.double().cpu()
    check(bool(torch.isfinite(g).all()), "non-finite count from the kernel")
    err = (g - r).abs()
    bad = err > C_ATOL + C_RTOL * r.abs()
    check(not bool(bad.any()),
          f"counts outside rtol {C_RTOL} / atol {C_ATOL}: max abs err "
          f"{float(err.max()):.3g}")
    return float(err.max())


def _max_prop(bdev):
    """The plain versions' delete-scan reach for a device batch (the widest
    strip, rounded up to a power of two)."""
    if "seg_width" not in bdev:
        return None
    m, p = int(bdev["seg_width"].max()), 1
    while p < m:
        p *= 2
    return p if m > 0 else None


ESTEP = ("fwd_store", "bwd_counts")  # K2, K3: a warp and a block route


def _estep_routes(W):
    """The K2/K3 routes held against each other on a band of W lanes: the
    warp route at estep.warp_lpt(W) where a warp covers W (up to 512
    lanes), then the block route."""
    from quaff_tpu_torch.dp.estep import warp_lpt

    lpt = warp_lpt(W)
    return [("block", 0)] if lpt is None else [("warp", lpt), ("block", 0)]


def estep_case(name, bdev, v2, local, card, n_plain=3, n_runs=3):
    """K2, K3 and the count reduction against their plain versions on one
    batch, each of K2's and K3's routes forced on the same inputs (and K3
    on each route's K2 store): agreement, the back-start posterior,
    bitwise repeatability, times and bounds.  Returns, per kernel and
    route kind, the kernels line's numbers."""
    import torch

    from quaff_tpu_torch.dp import estep, fill_v2

    inp = fill_v2.kernel_inputs(bdev)
    mp = _max_prop(bdev)
    B, W = inp["doff"].shape
    Ly = inp["keys"].shape[1]
    routes = _estep_routes(W)
    auto = {k: estep.estep_route(W, k) for k in ESTEP}

    def k2(keys, route=None):
        return estep.fwd_store(**dict(inp, keys=keys), tables=v2, local=local,
                               route=route)

    def p2(keys):
        return estep.fwd_store_reference(**dict(inp, keys=keys), tables=v2,
                                         local=local, max_prop=mp)

    # K2 on each route, against the plain version, and again bit for bit
    ref2, t_p2 = _timed(p2, inp["keys"])
    stores, err_f = {}, {}
    for r in routes:
        stores[r[0]] = k2(inp["keys"], r)
        err_f[r[0]] = _compare(stores[r[0]][0], ref2[0])
        check(torch.equal(stores[r[0]][0], k2(inp["keys"], r)[0]),
              f"{name}: two runs of K2's {r[0]} route differ")
    del ref2
    fwd, rows, offs = stores[auto["fwd_store"][0]]
    fin = fwd > fill_v2.NEG_INF / 2
    wrow = torch.stack([fin.float(), torch.where(fin, fwd, 0.0)]).contiguous()
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)

    def k3(w, route=None, store=None):
        st = (rows, offs) if store is None else store
        return estep.bwd_counts(*base, w, *st, local=local, route=route)

    def p3(w):
        return estep.bwd_counts_reference(*base, w, rows, offs, local=local,
                                          max_prop=mp)

    # K3 on each route, on each route's K2 store (the layout they share),
    # against the plain version on estep_route's store: every pairing
    (part_p, sc_p), t_p3 = _timed(p3, wrow)
    want = torch.cat([part_p.ravel(), sc_p.ravel()])
    del part_p, sc_p
    err_c, bsp_err = {}, 0.0
    for r3 in routes:
        for r2 in routes:
            part, sc = k3(wrow, r3, stores[r2[0]][1:])
            err = _compare_counts(torch.cat([part.ravel(), sc.ravel()]), want)
            err_c[r3[0]] = max(err_c.get(r3[0], 0.0), err)
            # each finite pair's back-start posterior exp(back - fwd) is 1
            # in exact arithmetic (rtol 5e-3, tests/test_pallas_counts.py)
            bsp = sc[4][fin].double().cpu()
            bsp_err = max(bsp_err, float((bsp - 1).abs().max()))
            check(bool(((bsp - 1).abs() < 5e-3).all()),
                  f"{name}: K3 {r3[0]} on K2 {r2[0]}: back-start posterior "
                  f"off 1 by {float((bsp - 1).abs().max()):.3g}")
            part2, sc2 = k3(wrow, r3, stores[r2[0]][1:])
            check(torch.equal(part, part2) and torch.equal(sc, sc2),
                  f"{name}: two runs of K3's {r3[0]} route differ")
            del part, sc, part2, sc2
    del want
    for r in routes:
        if r[0] != auto["fwd_store"][0]:
            del stores[r[0]]
    part, sc = k3(wrow)
    tab = estep.estep_reduce(part)
    tab_p, t_red_p = _timed(estep.estep_reduce_reference, part)
    err_r = float((tab - tab_p).abs().max())
    check(torch.equal(tab, tab_p), f"{name}: the count reduction differs "
          f"from its plain version (max abs err {err_r:.3g}), not bit for bit")
    del tab_p
    # the whole E-step again on estep_route's routes: the tables must
    # repeat bit for bit
    fwd2, rows2, offs2 = k2(inp["keys"])
    part2, sc2 = estep.bwd_counts(*base, wrow, rows2, offs2, local=local)
    tab2 = estep.estep_reduce(part2)
    check(torch.equal(fwd, fwd2) and torch.equal(sc, sc2)
          and torch.equal(tab, tab2), f"{name}: two runs differ")
    del fwd2, rows2, offs2, part2, sc2, tab2

    variants = []
    for i in range(n_runs + 1):
        k = inp["keys"].clone()
        k[:, i % Ly, 1] = (k[:, i % Ly, 1] + 1) % 40
        variants.append(k)
    wv = [(wrow * torch.tensor([[1.0 + 1e-3 * i], [1.0]], device=wrow.device)
           ).contiguous() for i in range(n_runs)]
    # each route on the same inputs (CUDA events, median of n_runs), the
    # plain versions: the comparison's run and n_plain - 1 more
    t = {"fwd_store": {}, "bwd_counts": {}}
    for r in routes:
        k2(variants[0], r)  # warm
        t["fwd_store"][r[0]] = _time(lambda k, r=r: k2(k, r), variants[1:])
        t["bwd_counts"][r[0]] = _time(lambda w, r=r: k3(w, r), wv)
    plain = {"fwd_store": statistics.median(
                 [t_p2] + _times(p2, variants[1:n_plain])),
             "bwd_counts": statistics.median(
                 [t_p3] + _times(p3, wv[:n_plain - 1]))}
    # the reduction and torch.sum, timed alike: device time (a graph of
    # 100 back-to-back calls), the eager 100, one call with host launch
    red = {}
    for k, fn in (("kernel", estep.estep_reduce),
                  ("torch.sum", lambda p: torch.sum(p, dim=0))):
        eager, dev = _back_to_back(fn, part)
        red[k] = {"device": dev, "eager": eager,
                  "host": _time(fn, [part] * n_runs)}

    cells = _cells(inp)
    n_rows = int(inp["meta"][:, 1].clamp(max=Ly).sum())
    # the row store K2 must write and K3 read back: M, I and D of every
    # in-envelope cell, and a float64 offset per row
    store = 12 * cells + 8 * n_rows
    k2_in = _fill_in_bytes(inp, v2)
    k3_in = (k2_in - _nbytes(inp["seg_start"], inp["seg_width"])
             + _nbytes(wrow))
    E = part.shape[1]
    bounds = {
        "fwd_store": _bound(k2_in + store
                            + 4 * B * (1 + inp["seg_start"].shape[1]),
                            OPS_PER_CELL["fwd_store"] * cells),
        "bwd_counts": _bound(k3_in + store + 4 * B * E + 20 * B,
                             OPS_PER_CELL["bwd_counts"] * cells),
        "estep_reduce": _bound(4 * B * E + 4 * E, B * E),
    }
    errs = {"fwd_store": err_f, "bwd_counts": err_c}
    out = {k: {r[0]: {"max_abs_err": errs[k][r[0]],
                      "ms": t[k][r[0]] * 1e3, "plain_ms": plain[k] * 1e3,
                      "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                      "library_ms": None, "route": r} for r in routes}
           for k in ESTEP}
    out["estep_reduce"] = {
        "max_abs_err": err_r, "ms": red["kernel"]["device"] * 1e3,
        "plain_ms": t_red_p * 1e3, "bound_ms": bounds["estep_reduce"][0],
        "bound_by": bounds["estep_reduce"][1],
        "library_ms": red["torch.sum"]["device"] * 1e3}
    log(f"phase 2b: {name}: B={B} W={W} Ly={Ly} "
        f"{'local' if local else 'global'}, {cells} in-envelope cells; "
        f"estep_route: K2 {auto['fwd_store']}, K3 {auto['bwd_counts']}; max "
        f"abs err fwd {max(err_f.values()):.3g}, counts "
        f"{max(err_c.values()):.3g} (routes {[r[0] for r in routes]}, K3 on "
        f"each route's K2 store); reduce bitwise equal to its plain version; "
        f"back-start posterior within {bsp_err:.3g} of 1; tables "
        f"bit-identical over two runs [{card}]")
    for k in ESTEP:
        v = out[k]
        times = ", ".join(
            f"{r[0]}{'' if r[0] == 'block' else ' ' + str(r[1])} "
            f"{v[r[0]]['ms']:.3f} ms" for r in routes)
        ratio = (f" (block/warp {v['block']['ms'] / v['warp']['ms']:.2f}x)"
                 if len(routes) == 2 else "")
        log(f"phase 2b: {name}: {k} {times}{ratio} (median of {n_runs}, same "
            f"inputs), plain {plain[k] * 1e3:.3f} ms (median of {n_plain}), "
            f"bound {bounds[k][0]:.4f} ms ({bounds[k][1]}) [{card}]")
    log(f"phase 2b: {name}: estep_reduce [{B}, {E}]: device time (graph of "
        f"100) {red['kernel']['device'] * 1e3:.4f} ms vs torch.sum "
        f"{red['torch.sum']['device'] * 1e3:.4f} ms; eager 100 back to back "
        f"{red['kernel']['eager'] * 1e3:.4f} vs "
        f"{red['torch.sum']['eager'] * 1e3:.4f} ms; with host launch "
        f"(median of {n_runs}) {red['kernel']['host'] * 1e3:.4f} vs "
        f"{red['torch.sum']['host'] * 1e3:.4f} ms; plain "
        f"{t_red_p * 1e3:.3f} ms (once); bound "
        f"{out['estep_reduce']['bound_ms']:.4f} ms "
        f"({out['estep_reduce']['bound_by']}) [{card}]")
    return out


def _cutover_pairs(rng, n, band=420):
    """Reads of 600 bp in a ref with no repeat, enveloped with a k-mer band
    of `band`: one strip a pair, 257-512 lanes wide (the warp routes'
    lanes-a-thread 16)."""
    from quaff_tpu_torch.envelope import sparse_envelope
    from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex

    pairs = []
    for b in range(n):
        core = "".join("ACGT"[t] for t in rng.integers(0, 4, 600))
        spacer = "".join("ACGT"[t] for t in rng.integers(0, 4, 200))
        ys = list(core)
        for i in range(len(ys)):
            if rng.random() < 0.06:
                ys[i] = "ACGT"[int(rng.integers(0, 4))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(ys)))
        x = FastSeq(name=f"x{b}", seq=spacer + core + spacer)
        y = FastSeq(name=f"y{b}", seq="".join(ys), qual=qual)
        pairs.append((x, y, sparse_envelope(x, KmerIndex(y, 6),
                                            band_size=band,
                                            kmer_threshold=10)))
    return pairs


def phase2b_estep(card):
    import numpy as np
    import torch

    from quaff_tpu_torch import kernels
    from quaff_tpu_torch.dp import estep
    from quaff_tpu_torch.dp.engine import PairBatch, to_device
    from quaff_tpu_torch.dp.fill_v2 import V2Tables
    from quaff_tpu_torch.dp.scores import ScoreTables
    from quaff_tpu_torch.envelope import full_envelope, make_envelope
    from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex, read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffParams, default_params

    tables = ScoreTables.from_params(default_params())
    gap1 = ScoreTables.from_params(QuaffParams.from_json(
        (DATA / "params-gaporder1.json").read_text()))

    def case(name, pb, tt, local, **kw):
        return estep_case(name, to_device(pb, "cuda"),
                          V2Tables.from_tables(tt, "cuda"), local, card, **kw)

    pairs = _synthetic_pairs(np.random.default_rng(7), 64)  # phase 2's
    case("gap order 0", PairBatch.build_packed(pairs, tables), tables, True)
    case("gap order 1", PairBatch.build_packed(pairs, gap1), gap1, True)
    case("global", PairBatch.build(
        [(xg, yg, full_envelope(len(xg.seq), len(yg.seq)))
         for xg, yg, _ in pairs[:16]], tables), tables, False)
    # the warp routes' cutover: lanes-a-thread 16 against the block route
    # on the same 257-512-lane batch, for each kernel
    cpb = PairBatch.build_packed(
        _cutover_pairs(np.random.default_rng(9), 32), tables)
    cW = cpb.member.shape[1]
    check(256 < cW <= 512, f"the cutover case has {cW} lanes, not 257-512")
    cut = case("cutover (257-512 lanes)", cpb, tables, True, n_plain=1)
    log(f"phase 2b: the warp routes' cutover at B={cpb.member.shape[0]} "
        f"W={cW}: " + "; ".join(
            f"{k} lanes-a-thread 16 {cut[k]['warp']['ms']:.3f} ms against "
            f"the block route's {cut[k]['block']['ms']:.3f} ms "
            f"({cut[k]['block']['ms'] / cut[k]['warp']['ms']:.2f}x), "
            f"ESTEP_WARP_MAX_LANES {estep.ESTEP_WARP_MAX_LANES[k]}"
            for k in ESTEP) + f" [{card}]")
    # a band wider than K2's and K3's shared-memory row state: global scratch
    dev = torch.cuda.current_device()
    limit = max(kernels.max_smem_lanes(dev),
                kernels.max_smem_lanes(dev, "bwd_counts"))
    rng = np.random.default_rng(8)
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, limit + 2000))
    wide = []
    for b in range(8):
        s0 = int(rng.integers(0, len(xs) - 400))
        yw = FastSeq(name=f"w{b}", seq=xs[s0:s0 + 400],
                     qual="".join(chr(33 + int(q))
                                  for q in rng.integers(3, 40, 400)))
        wide.append((FastSeq(name="xw", seq=xs), yw, full_envelope(len(xs), 400)))
    wpb = PairBatch.build(wide, tables)
    check(wpb.member.shape[1] > limit, "wide case fits shared memory")
    case(f"wide (W > {limit} smem lanes)", wpb, tables, True)
    # the c8f30 self pair of `train c8f30 c8f30 -kmatchmb 10 -fwdstrand`
    y = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0]
    x.qual = ""
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=-1, cell_size=48,
                        max_size=10 << 20)
    case("c8f30 self pair", PairBatch.build_packed([(x, y, env)], tables),
         tables, True, n_plain=1)


# ---------------------------------------------------------------- phase 3b


def _json_close(mine, want, rtol, atol, skip=()):
    """Paths where two JSON documents differ beyond atol + rtol*|want|."""
    bad = []

    def walk(a, b, path):
        if isinstance(a, dict):
            check(isinstance(b, dict) and a.keys() == b.keys(),
                  f"{path}: keys differ")
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            check(isinstance(b, list) and len(a) == len(b),
                  f"{path}: lengths differ")
            for i, (u, v) in enumerate(zip(a, b)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(a, (int, float)) and not isinstance(a, bool):
            if any(path.startswith(p) for p in skip):
                return
            if not abs(float(a) - float(b)) <= atol + rtol * abs(float(b)):
                bad.append((path, a, b))
        else:
            check(a == b, f"{path}: {a!r} != {b!r}")

    walk(mine, want, "")
    return bad


ROUTE_COUNTS = ("launches", "warp_launches", "block_launches")


def _estep_launches():
    """The E-step wrappers' launch counts: K2's and K3's by route."""
    from quaff_tpu_torch.dp import estep

    out = {k: {c: getattr(getattr(estep, k), c) for c in ROUTE_COUNTS}
           for k in ESTEP}
    out["estep_reduce"] = {"launches": estep.estep_reduce.launches}
    return out


def _reset_launches():
    from quaff_tpu_torch.dp import estep, fill_v2, ov_fill

    for k in FILL_COUNTS:
        setattr(fill_v2.band_fill, k, 0)
    for k in OV_COUNTS:
        setattr(ov_fill.ov_fill, k, 0)
    for k in ESTEP:
        for c in ROUTE_COUNTS:
            setattr(getattr(estep, k), c, 0)
    estep.estep_reduce.launches = 0


@contextlib.contextmanager
def _estep_chunks():
    """Records the width and pairs of each fused E-step chunk a run makes
    (estep_fused_multi's batch): yields the list it fills."""
    from quaff_tpu_torch.dp import estep

    chunks, orig = [], estep.estep_fused_multi

    def recording(v2tab, batch, gid, null_lls, local=True, max_prop=None):
        chunks.append({"B": int(batch["member"].shape[0]),
                       "W": int(batch["member"].shape[1]), "batch": batch,
                       "v2": v2tab, "local": local})
        return orig(v2tab, batch, gid, null_lls, local, max_prop)

    estep.estep_fused_multi = recording
    try:
        yield chunks
    finally:
        estep.estep_fused_multi = orig


def _check_routes(what, chunks, n):
    """Each chunk's K2 and K3 took estep_route's route: the launch counts
    by route n equal the chunks' routes.  Returns the routes by chunk."""
    from quaff_tpu_torch.dp import estep

    routes = [{k: estep.estep_route(c["W"], k) for k in ESTEP}
              for c in chunks]
    for k in ESTEP:
        want = {r: sum(c[k][0] == r for c in routes)
                for r in ("warp", "block")}
        got = {r: n[k][f"{r}_launches"] for r in ("warp", "block")}
        check(got == want, f"{what}: {k} launches by route {got}, the "
              f"chunks' estep_route {want}")
    return routes


def _timing(spent, owner, name, key, static=False):
    """Times each call of owner.name into spent[key] (host seconds, fenced
    by torch.cuda.synchronize before and after); returns what restores
    it."""
    import torch

    fn = vars(owner)[name]
    raw = fn.__func__ if static else fn

    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = raw(*a, **k)
        torch.cuda.synchronize()
        spent.setdefault(key, []).append(time.perf_counter() - t0)
        return res

    setattr(owner, name, classmethod(wrapper) if static else wrapper)
    return owner, name, fn


def _kernel_events(prof, part):
    """(name, device ms) of each kernel launch whose name holds `part`, in
    launch order, from a torch.profiler run."""
    from torch.autograd import DeviceType

    evs = [e for e in prof.events()
           if e.device_type == DeviceType.CUDA and part in e.name]
    evs.sort(key=lambda e: e.time_range.start)
    return [(e.name, e.time_range.elapsed_us() / 1e3) for e in evs]


def _device_busy(prof):
    """Device seconds by kernel name from a torch.profiler run."""
    device = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0))
        if t > 0:
            device[e.key] = t / 1e6
    return device


def _loglikes(err):
    import re

    return [float(v) for v in re.findall(r"log-likelihood \(([^)]*)\)", err)]


def _route_text(chunks, routes):
    return "; ".join(
        f"(B={c['B']}, W={c['W']}: K2 {r['fwd_store'][0]}"
        f"{'' if r['fwd_store'][0] == 'block' else ' ' + str(r['fwd_store'][1])}"
        f", K3 {r['bwd_counts'][0]}"
        f"{'' if r['bwd_counts'][0] == 'block' else ' ' + str(r['bwd_counts'][1])})"
        for c, r in zip(chunks, routes))


def _route_name(route):
    return route[0] if route[0] == "block" else f"{route[0]} {route[1]}"


def phase3b_train_goldens(card):
    """The train golden and count -fast through the CLI on the card, each
    chunk's K2/K3 routes printed; then count -fast with a k-mer band wider
    than any warp route, whose run is the block routes' path.  Returns
    that run's launches and its E-step chunk."""
    from quaff_tpu_torch.logger import logger

    c8 = str(DATA / "c8f30.fastq.gz")
    _reset_launches()
    t0 = time.perf_counter()
    with _estep_chunks() as chunks:
        out, err = _cli(["train", c8, c8, "-kmatchmb", "10", "-fwdstrand",
                         "-maxiter", "2", "-v"], "cuda", stderr=True)
    logger.verbosity = 0
    dt = time.perf_counter() - t0
    n = _estep_launches()
    check(min(v["launches"] for v in n.values()) > 0,
          f"c8f30 train: a kernel was not launched {n}")
    routes = _check_routes("c8f30 train", chunks, n)
    lls = re.findall(r"log-likelihood \(([^)]*)\)", err)
    check(lls[:2] == ["-22808.4", "-17564.7"],
          f"c8f30 train: log-likelihoods {lls}, want -22808.4, -17564.7")
    want = json.loads((DATA / "c8f30-train2.oracle.json").read_text())
    bad = _json_close(json.loads(out), want, 2e-3, 1e-4, skip=("/refBase",))
    check(not bad, f"c8f30 train vs c8f30-train2.oracle.json: {bad[:5]}")
    log(f"phase 3b: train c8f30 (2 EM iterations): log-likelihoods "
        f"{lls[0]}, {lls[1]} and params within 1e-4 + 2e-3*|want| of "
        f"c8f30-train2.oracle.json; chunks {_route_text(chunks, routes)}; "
        f"launches {n}; {dt:.2f} s [{card}]")

    args = [str(DATA / "synth12-genome.fasta"), str(DATA / "synth12.fastq"),
            "-kmatchn", "10", "-fwdstrand"]
    wide, wide_chunk = {}, None
    for band in (None, 600):
        extra = [] if band is None else ["-kmatchband", str(band)]
        _reset_launches()
        with _estep_chunks() as chunks:
            fast = json.loads(_cli(["count", *args, *extra, "-fast"], "cuda"))
        n = _estep_launches()
        check(min(v["launches"] for v in n.values()) > 0,
              f"count -fast: a kernel was not launched {n}")
        routes = _check_routes(f"count -fast {extra}", chunks, n)
        parity = json.loads(_cli(["count", *args, *extra], "cuda"))
        bad = _json_close(fast, parity, 5e-3, 5e-3)
        check(not bad, f"count -fast {extra} vs count: {bad[:5]}")
        log(f"phase 3b: count -fast synth12{' ' + ' '.join(extra) if extra else ''} "
            f"within 5e-3 + 5e-3*|count| of the float64 parity count; chunks "
            f"{_route_text(chunks, routes)}; launches {n} [{card}]")
        if band is not None:
            check(all(n[k]["block_launches"] > 0 for k in ESTEP),
                  f"count -fast -kmatchband {band}: no block-route launch {n}")
            wide = n
            wide_chunk = max(chunks, key=lambda c: c["B"] * c["W"])
    return wide, wide_chunk


# ---------------------------------------------------------------- phase 5


def phase5_train(card, n_reads=128, genome_len=200_000, n_check=8):
    """`train -maxiter 2` on a size users run, through the CLI on the card;
    returns the main path's launches and its largest E-step chunk."""
    import torch

    from quaff_tpu_torch import trainer
    from quaff_tpu_torch.dp import estep

    threads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        gpath, rpath, head, genome, origins = _workload(
            tmp, seed=2, n_reads=n_reads, genome_len=genome_len,
            n_head=n_check)
        from torch.profiler import ProfilerActivity, profile

        from quaff_tpu_torch.dp import engine
        from quaff_tpu_torch.model.params import QuaffParamCounts


        spent = {}  # host seconds per step of the path, device fenced

        def timing(owner, name, key, static=False):
            return _timing(spent, owner, name, key, static)

        with _estep_chunks() as chunks:
            patched = [
                timing(trainer.QuaffCounter, "get_counts", "E-step"),
                timing(trainer.QuaffCounter, "_envelopes", "envelopes"),
                timing(engine.PairBatch, "build_packed", "batch layout",
                       static=True),
                timing(trainer, "to_device", "host-to-device"),
                timing(estep, "estep_fused_multi",
                       "fused E-step on the card"),
                timing(QuaffParamCounts, "fit", "M-step"),
            ]
            try:
                torch.cuda.reset_peak_memory_stats()
                _reset_launches()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    out, err = _cli(["train", str(gpath), str(rpath),
                                     "-maxiter", "2", "-threads", threads,
                                     "-v"], "cuda", stderr=True)
                    wall = time.perf_counter() - t0
                launches = _estep_launches()
            finally:
                for owner, name, fn in reversed(patched):
                    setattr(owner, name, fn)
        estep_s = spent["E-step"]
        device = _device_busy(prof)
        busy = sum(device.values())
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        from quaff_tpu_torch.logger import logger

        logger.verbosity = 0
        check(min(v["launches"] for v in launches.values()) > 0,
              f"the train path missed a kernel: {launches}")
        routes = _check_routes("phase 5", chunks, launches)
        check(all(launches[k]["warp_launches"] > 0 for k in ESTEP),
              f"the train path launched no K2 or K3 on the warp route: "
              f"{launches}")
        # each chunk's K2 and K3 device time, by the profiler's kernel names
        from quaff_tpu_torch.prof.kernel_sass import kernel_of

        evs = {k: [] for k in ESTEP}
        for ename, ms in _kernel_events(prof, ""):
            owner = kernel_of(ename)
            if owner is not None and owner[0] in evs:
                evs[owner[0]].append((owner[1], ms))
        check(all(len(evs[k]) == len(chunks) for k in ESTEP),
              f"phase 5: {[len(evs[k]) for k in ESTEP]} K2/K3 kernels "
              f"traced for {len(chunks)} chunks")
        for c, r, e2, e3 in zip(chunks, routes, evs["fwd_store"],
                                evs["bwd_counts"]):
            check(e2[0] == r["fwd_store"][0] and e3[0] == r["bwd_counts"][0],
                  f"phase 5: a chunk of W={c['W']} ran K2 {e2[0]}, K3 "
                  f"{e3[0]}, not estep_route's {r}")
        dev_ms = {k: {"warp": 0.0, "block": 0.0} for k in ESTEP}
        for k in ESTEP:
            for route, ms in evs[k]:
                dev_ms[k][route] += ms
        biggest = max(chunks, key=lambda c: c["B"] * c["W"])
        lls = _loglikes(err)
        check(len(lls) == 2 and lls[1] > lls[0],
              f"log-likelihood did not rise over 2 EM iterations: {lls}")
        json.loads(out)
        check(not re.search(r"nan|inf", out.lower()),
              "fitted parameters are not finite")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"phase 5: train {n_reads} reads (2-10 kb) vs a {genome_len} bp "
            f"genome, 2 EM iterations on cuda: {wall:.2f} s wall "
            f"({wall / 2:.2f} s per EM iteration); E-step "
            f"{', '.join(f'{t:.2f}' for t in estep_s)} s; log-likelihoods "
            f"{lls[0]:.6g} -> {lls[1]:.6g}; {sum(c['B'] for c in chunks)} "
            f"pair fills in chunks of {[c['B'] for c in chunks]}; launches "
            f"{launches}; peak device memory {peak:.2f} GiB [{card}]")
        log("phase 5: E-step chunks (B, W, K2 route, K2 device ms, K3 route, "
            "K3 device ms): " + "; ".join(
                f"({c['B']}, {c['W']}, {_route_name(r['fwd_store'])}, "
                f"{e2[1]:.3f}, {_route_name(r['bwd_counts'])}, {e3[1]:.3f})"
                for c, r, e2, e3 in zip(chunks, routes, evs["fwd_store"],
                                        evs["bwd_counts"]))
            + "; by route: " + "; ".join(
                f"{k} warp {dev_ms[k]['warp']:.3f} ms, block "
                f"{dev_ms[k]['block']:.3f} ms" for k in ESTEP)
            + f" [{card}]")
        log("phase 5: where the time goes (host seconds, fenced by "
            "synchronize; summed over both iterations): "
            + "; ".join(f"{k} {sum(v):.3f} s in {len(v)} calls"
                        for k, v in spent.items()))
        log(f"phase 5: torch.profiler: device busy {busy:.3f} s of "
            f"{wall:.3f} s wall ({100 * busy / wall:.2f}%); top: "
            + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in top)
            + f" [{card}]")

        # the E-step's chunk plan reads no free memory: count -fast on all
        # the reads, then again while a tensor holds all but 8 GiB of the
        # card's free memory (the run's chunk needs ~5.2 GB), byte for byte
        plans = []
        orig_plan = trainer.estep_chunk_plan

        def plan_recording(*a, **k):
            plans.append(orig_plan(*a, **k))
            return plans[-1]

        trainer.estep_chunk_plan = plan_recording
        args = ["count", str(gpath), str(rpath), "-fast", "-threads", threads]
        t0 = time.perf_counter()
        try:
            first = _cli(args, "cuda")
            torch.cuda.empty_cache()
            free0 = torch.cuda.mem_get_info()[0]
            hold = torch.empty(max(free0 - (8 << 30), 0), dtype=torch.uint8,
                               device="cuda")
            free1 = torch.cuda.mem_get_info()[0]
            second = _cli(args, "cuda")
            del hold
            torch.cuda.empty_cache()
        finally:
            trainer.estep_chunk_plan = orig_plan
        check(first == second,
              f"phase 5: count -fast with {free0 / 2**30:.1f} and then "
              f"{free1 / 2**30:.1f} GiB free on the card: the outputs differ")
        log(f"phase 5: count -fast on all {n_reads} reads with "
            f"{free0 / 2**30:.1f} GiB and then {free1 / 2**30:.1f} GiB free "
            f"on the card: byte-identical JSON; reads a chunk "
            f"{[[len(c) for c in p[0]] for p in plans]}, oversize "
            f"{[len(p[1]) for p in plans]} ({time.perf_counter() - t0:.1f} "
            f"s) [{card}]")

        # count -fast against the float64 parity count, read by read, each
        # read against its source window of the genome (+-200 bp, on the
        # read's strand): the parity engine fills a pair's bounding band,
        # and against the whole genome that band spans the diagonals from
        # 0 to the read's origin (10^5 lanes)
        import numpy as np

        acgt = np.frombuffer(b"ACGT", np.uint8)
        reads = rpath.read_text().splitlines()
        t0 = time.perf_counter()
        for i, (s0, n, rev) in enumerate(origins[:n_check]):
            w = genome[max(s0 - 200, 0):s0 + n + 200]
            if rev:
                w = (3 - w)[::-1]
            wpath, ypath = tmp / "window.fasta", tmp / "read.fastq"
            wpath.write_text(f">window{i}\n{acgt[w].tobytes().decode()}\n")
            ypath.write_text("\n".join(reads[4 * i:4 * i + 4]) + "\n")
            args = [str(wpath), str(ypath), "-fwdstrand"]
            fast = json.loads(_cli(["count", *args, "-fast"], "cuda"))
            parity = json.loads(_cli(["count", *args], "cuda"))
            bad = _json_close(fast, parity, 5e-3, 5e-3)
            check(not bad, f"count -fast vs count, read {i}: {bad[:5]}")
        log(f"phase 5: count -fast on each of the first {n_check} reads "
            f"against its genome window: within 5e-3 + 5e-3*|count| of the "
            f"float64 parity count ({time.perf_counter() - t0:.1f} s)")
    return launches, biggest


# ---------------------------------------------------------------- phase 2c

# float32 operations per in-envelope cell that K4's function needs, counted
# from the cell update of csrc/ov_fill.cu (a log-add-exp counts 6: max,
# subtract, abs, exp, log1p, add): the emission 24, match 6, insert 10,
# the delete recurrence 10 (as a sequential chain would do it: the
# kernel's scan composes triples on top), the end 1; gap order > 0 adds
# the per-cell m2m and m2d, 2 more (K1's 13 count no scan either)
OV_OPS_PER_CELL = {5: 51, 7: 53}


def _ov_windows(inp):
    """Per pair and lane of a K4 batch, the live rows [lo, hi] of its
    in-envelope cells (numpy int64 [B, W], hi < lo where there are none)."""
    import numpy as np

    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    d = inp["doff"].cpu().numpy().astype(np.int64)
    meta = inp["meta"].cpu().numpy().astype(np.int64)
    xlen, ylen, joff, nrows = (meta[:, k : k + 1] for k in (2, 3, 4, 5))
    lo = np.maximum(joff + 1, 1 - d)
    hi = np.minimum(np.minimum(joff + nrows, ylen), xlen - d)
    hi = np.where(d != D_SENTINEL, hi, lo - 1)
    return d, lo, hi


def _ov_cells(inp):
    _, lo, hi = _ov_windows(inp)
    return int((hi - lo + 1).clip(min=0).sum())


def _ov_bytes(inp):
    """Bytes K4 must move for a batch, each input read once: the bank
    values its cells read (each (bank row, position) once: x values at
    i - 1 of every in-envelope cell, y values of every live row), the
    per-pair inputs, the transitions and the output."""
    import numpy as np

    d, lo, hi = _ov_windows(inp)
    meta = inp["meta"].cpu().numpy().astype(np.int64)
    NR, C, L = inp["bank"].shape
    used = np.zeros((NR, L + 1), np.int32)  # +1/-1 marks of touched spans
    for b in range(d.shape[0]):
        ok = hi[b] >= lo[b]
        if not ok.any():
            continue
        starts = d[b][ok] + lo[b][ok] - 1
        ends = d[b][ok] + hi[b][ok] - 1
        order = np.argsort(starts)
        starts, ends = starts[order], np.maximum.accumulate(ends[order])
        new = np.concatenate([[True], starts[1:] > ends[:-1] + 1])
        s0 = starts[new]
        e0 = np.append(ends[np.nonzero(new)[0][1:] - 1], ends[-1])
        np.add.at(used[meta[b, 0]], s0, 1)
        np.add.at(used[meta[b, 0]], e0 + 1, -1)
        y0, y1 = meta[b, 4], min(meta[b, 4] + meta[b, 5], meta[b, 3])
        used[meta[b, 1], y0] += 1
        used[meta[b, 1], y1] -= 1
    touched = int((np.cumsum(used, axis=1)[:, :L] > 0).sum())
    B, S = inp["seg_start"].shape
    return (4 * C * touched
            + _nbytes(inp["meta"], inp["doff"], inp["seg_start"],
                      inp["seg_width"], inp["ins_xy"], inp["trans"])
            + 4 * (B + B * S))


def _ov_subset(inp, n, last=False):
    """The first (or last) n pairs of a K4 batch (the bank stays whole)."""
    cut = slice(-n, None) if last else slice(None, n)
    return {k: (v if k in ("bank", "trans") else v[cut].contiguous())
            for k, v in inp.items()}


OV_COUNTS = ("launches", "warp_launches", "cluster_launches")


def _ov_counts():
    from quaff_tpu_torch.dp import ov_fill

    return {k: getattr(ov_fill.ov_fill, k) for k in OV_COUNTS}


def _ov_time(batch, route, n_runs=3):
    """Median ms of K4 on `route` over n_runs distinct inputs (the
    delete-extend log moved), after a warm run."""
    import torch

    from quaff_tpu_torch.dp import ov_fill

    def kern(v):
        return ov_fill.ov_fill(**v, route=route)

    vs = [dict(batch, trans=(batch["trans"] + torch.tensor(
        [0.0] * 8 + [1e-4 * (i + 1)], device="cuda")).contiguous())
        for i in range(n_runs + 1)]
    kern(vs[0])
    return _time(kern, vs[1:]) * 1e3


def ov_case(name, inp, card, n_plain=None, n_runs=3, routes=(None,),
            last=False):
    """K4 and its plain version on one batch (the plain version on its
    first n_plain pairs, or its last with last=True, timed once): for each
    of `routes` (None: ov_route's pick; else a route forced on the same
    inputs) agreement, a rerun bit for bit, times, in-envelope cells/s and
    the bound, and that every launch took that route.  Returns one dict per
    route."""
    import torch

    from quaff_tpu_torch.dp import ov_fill

    B, W = inp["doff"].shape
    routes = [r or ov_fill.ov_route(W) for r in routes]
    sub = (inp if n_plain is None or n_plain >= B
           else _ov_subset(inp, n_plain, last))
    Bs = sub["doff"].shape[0]
    ref, t_ref = _timed(lambda v: ov_fill.ov_fill_reference(**v), sub)
    plain_ms = t_ref * 1e3
    fin = torch.isfinite(ref[:Bs])
    check(bool(fin.all()), f"{name}: a pair has no finite overlap score")

    shapes = {}
    for tag, batch in (("all", inp), ("sub", sub)):
        cells = _ov_cells(batch)
        C = batch["bank"].shape[1]
        bound_ms, bound_by = _bound(_ov_bytes(batch),
                                    OV_OPS_PER_CELL[C] * cells)
        shapes[tag] = (batch, cells, bound_ms, bound_by)
    which = f"last {Bs}" if last else f"first {Bs}"
    out = []
    for route in routes:
        before = _ov_counts()

        got = ov_fill.ov_fill(**sub, route=route)
        check(torch.equal(ov_fill.ov_fill(**sub, route=route), got),
              f"{name}: a rerun of K4 on the same inputs is not "
              "bit-identical")
        err = _compare(got, ref, OV_RTOL, OV_ATOL)
        res = {}
        for tag, (batch, cells, bound_ms, bound_by) in shapes.items():
            res[tag] = {"ms": _ov_time(batch, route, n_runs), "cells": cells,
                        "bound_ms": bound_ms, "bound_by": bound_by}
        moved = {k: v - before[k] for k, v in _ov_counts().items()}
        n = moved["launches"]
        check(n > 0 and moved[f"{route[0]}_launches"] == n,
              f"{name}: K4's launches by route {moved}, want all {n} on "
              f"the {route[0]} route")
        a, s_ = res["all"], res["sub"]
        how = _route_label(route)
        log(f"{name}: B={B} W={W} "
            f"rows<={int(inp['meta'][:, 5].max())} C={inp['bank'].shape[1]} "
            f"({how}): max abs err {err:.3g} ({Bs} pairs); K4 "
            f"{a['ms']:.3f} ms (median of {n_runs}), {a['cells']} "
            f"in-envelope cells, {a['cells'] / (a['ms'] / 1e3):.4g} cells/s, "
            f"bound {a['bound_ms']:.4f} ms ({a['bound_by']}) [{card}]")
        if sub is not inp:
            log(f"{name}, {which} pairs ({how}): K4 "
                f"{s_['ms']:.3f} ms, plain {plain_ms:.3f} ms (once), "
                f"{s_['cells']} cells, bound {s_['bound_ms']:.4f} ms "
                f"({s_['bound_by']}) [{card}]")
        else:
            log(f"{name}: plain {plain_ms:.3f} ms (once) [{card}]")
        out.append({"max_abs_err": err, "ms": s_["ms"], "plain_ms": plain_ms,
                    "bound_ms": s_["bound_ms"], "bound_by": s_["bound_by"],
                    "library_ms": None, "full": a, "route": route})
    return out


def _overlap_aligner(params, null, threads=1):
    from quaff_tpu_torch.aligner import DPConfig
    from quaff_tpu_torch.overlap import QuaffOverlapAligner

    return QuaffOverlapAligner(params, null,
                               DPConfig(device="cuda", threads=threads))


def phase2c_overlap_kernel(card):
    """K4 against its plain version, at gap order 0 and 1: per case 64
    overlapping pairs of 2-10 kb reads, half of them reverse strand, every
    other read without qualities (a batch mixes both strands and both
    kinds of reads: the bank's rows carry them).  Per gap order two
    batches: the 64 widest pairs (their widest band, 7211 lanes, takes the
    cluster route), and the 64 widest pairs the warp route takes, on the
    warp route and on the cluster route forced on the same inputs."""
    import numpy as np

    from quaff_tpu_torch.dp import ov_fill
    from quaff_tpu_torch.dp.fill_v2 import cluster_tiling
    from quaff_tpu_torch.io.fastseq import FastSeq, add_revcomps, read_fast_seqs
    from quaff_tpu_torch.model.params import (QuaffNullParams, QuaffParams,
                                              default_params)

    with tempfile.TemporaryDirectory() as d:
        _, rpath, _, _, _ = _workload(pathlib.Path(d), seed=4, n_reads=40,
                                      genome_len=30_000, n_head=1)
        reads = [r if i % 2 == 0 else FastSeq(name=r.name, seq=r.seq)
                 for i, r in enumerate(read_fast_seqs(str(rpath)))]
    seqs = add_revcomps(reads)
    null = QuaffNullParams.fit(reads)
    gap1 = QuaffParams.from_json((DATA / "params-gaporder1.json").read_text())
    for name, params in (("gap order 0", default_params()),
                         ("gap order 1", gap1)):
        aligner = _overlap_aligner(params, null)
        built = [t for t in aligner._pair_jobs(
            seqs, list(aligner.enumerate_pairs(seqs, len(reads)))) if not t[2]]
        # overlapping pairs first (multi-strip, most member lanes)
        built.sort(key=lambda t: (-int((t[1][3][0] > 0).sum()),
                                  -int(t[1][0][0].sum())))
        packed = {(j[0], j[1]): desc for j, desc, _ in built}
        warp_max = ov_fill.OV_WARP_MAX_LANES
        for which, fits in (("widest", lambda w: True),
                            ("warp-route", lambda w: w <= warp_max)):
            ok = [j for j, desc, _ in built if fits(desc[0].shape[1])]
            top = ([j for j in ok if not j[2]][:32]
                   + [j for j in ok if j[2]][:32])

            # the plain version's pairs (its row loop takes ~5 ms a row,
            # so all 64 would be ~45 s): for each strand, the two pairs of
            # reads with qualities and the two of reads without that have
            # the fewest live rows, multi-strip pairs first, among the 64
            # widest (the warp-route batch: among all it takes); they lead
            # the chunk, the widest others fill it to 32 of each strand
            def kind(j):
                return j[2], seqs[j[0]].has_qual(), seqs[j[1]].has_qual()

            def fewest_rows(j):
                return (np.count_nonzero(packed[j[:2]][3][0]) < 2,
                        int(packed[j[:2]][5][0]))

            pool = top if which == "widest" else ok
            sub = []
            for key in [(yc, q, q) for yc in (False, True)
                        for q in (True, False)]:
                sub += sorted((j for j in pool if kind(j) == key),
                              key=fewest_rows)[:2]
            check(len({kind(j) for j in sub}) == 4,
                  f"{name}: the plain version's pairs miss a strand or kind")
            chunk = list(sub)
            for yc in (False, True):
                n = 32 - sum(j[2] == yc for j in sub)
                chunk += [j for j in ok if j[2] == yc
                          and all(j is not k for k in sub)][:n]
            _, batch = next(aligner._kernel_batches(seqs, [chunk], packed))
            inp = ov_fill.prepare(
                ov_fill.ov_tables(aligner._tables(False), "cuda"), batch)
            check(len(chunk) == 64, f"{name}: {len(chunk)} pairs, not 64")
            W = inp["doff"].shape[1]
            route = ov_fill.ov_route(W)
            check((route[0] == "warp") == (which == "warp-route"),
                  f"{name}, {which} pairs: W={W} takes the {route} route")
            routes = (None,) if route[0] == "cluster" else (
                None, ("cluster", cluster_tiling(W, ov_fill.OV_CLUSTER_TABLE)))
            ov_case(f"phase 2c: {name}, {which} pairs, both strands, with "
                    f"and without qualities", inp, card, n_plain=len(sub),
                    routes=routes)


# ---------------------------------------------------------------- phase 2d

# the probes' shape: K1's production batch, one thread a lane
PROBE_B, PROBE_W = 2048, 256
# the log-add-exp chains against their plain versions: expf and log1pf of
# the card and PyTorch's kernels may differ by an ulp a step, over 128
# steps, and the chain grows only like log(steps)
LSE_RTOL, LSE_ATOL = 1e-6, 1e-5
SOL_ENTRIES = (
    ("sol_chain_add_max", ("add_max",), "tools/prof/roofline_probe.py:78"),
    ("sol_chain_roll_add", ("roll_add",), "tools/prof/roofline_probe.py:78"),
    ("sol_chain_lse", ("lse_guarded", "raw_lse", "raw_lse_log"),
     "tools/prof/sol_transcendental.py:29"),
)


def phase2d_sol_probes(card):
    """The probes' chain kernel against its plain version, each op at
    [2048, 256] over GRID 2 x 64 steps; then both probes as a user runs them
    (python -m quaff_tpu_torch.prof.roofline_probe, then
    ...sol_transcendental), with the chain's launches counted; then the
    plain chains at the probes' [2048, 256], GRID 512 x 64 steps, for the
    kernels line."""
    import torch

    from quaff_tpu_torch.prof import chains, roofline_probe, sol_transcendental

    t0 = time.perf_counter()
    exact = ("add_max", "roll_add")
    p1_in = roofline_probe.p1_inputs(PROBE_B, PROBE_W, "cuda")
    p2_in = sol_transcendental.p2_inputs(PROBE_B, PROBE_W, "cuda")
    err = {}
    for op in chains.OPS:
        a, b = p1_in if op in exact else p2_in
        got = chains.chain(op, a, b, 2, 64)
        ref = chains.chain_reference(op, a, b, 2, 64)
        err[op] = float((got - ref).abs().max())
        if op in exact:
            check(torch.equal(got, ref),
                  f"phase 2d: {op} chain is not bitwise equal to its plain "
                  f"version (max abs err {err[op]:.3g})")
        else:
            check(bool(torch.allclose(got, ref, rtol=LSE_RTOL, atol=LSE_ATOL)),
                  f"phase 2d: {op} chain outside rtol {LSE_RTOL} / atol "
                  f"{LSE_ATOL} of its plain version: max abs err "
                  f"{err[op]:.3g}")
    log(f"phase 2d: chain kernel vs plain at [{PROBE_B},{PROBE_W}], GRID 2 x "
        f"64 steps: add_max and roll_add bitwise equal; lse max abs err "
        + ", ".join(f"{op} {err[op]:.3g}" for op in chains.OPS[2:])
        + f" (rtol {LSE_RTOL} / atol {LSE_ATOL}) [{card}]")

    def out(line):
        log(f"phase 2d: {line}")

    chains.chain.launches.clear()
    p1 = roofline_probe.run(card, out)
    add_max = {(r["B"], r["W"]): r["step_s"] for r in p1["chains"]
               if r["op"] == "add_max"}
    p2 = sol_transcendental.run(card, out, add_max_step=add_max)
    launches = dict(chains.chain.launches)
    check(all(launches.get(op, 0) > 0 for op in chains.OPS),
          f"phase 2d: the probes did not launch every op: {launches}")
    log(f"phase 2d: chain launches in the probes' run: {launches}")

    # the kernels line: the kernel's time at [2048, 256], GRID 512 x 64
    # steps from the probes' run, the plain version once on the same inputs
    timed = {r["op"]: r for r in p1["chains"] + p2["costs"]
             if (r["B"], r["W"]) == (PROBE_B, PROBE_W)}
    entries = []
    for name, ops, replaces in SOL_ENTRIES:
        op = ops[0]
        r = timed[op]
        a, b = p1_in if op in exact else p2_in
        steps = r["grid"] * r["iters"][0]
        _, t_plain = _timed(lambda v: chains.chain_reference(
            op, v, b, r["grid"], r["iters"][0]), a)
        elems = PROBE_B * PROBE_W
        bound_ms, bound_by = _bound(3 * 4 * elems,
                                    chains.OPS_PER_ELEM[op] * elems * steps)
        e = dict(name=name, route="cuda",
                 source="quaff_tpu_torch/csrc/sol_probe.cu",
                 replaces=replaces, launches=sum(launches[o] for o in ops),
                 max_abs_err=max(err[o] for o in ops), ms=r["t_lo"] * 1e3,
                 plain_ms=t_plain * 1e3, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=None)
        entries.append(e)
        log(f"phase 2d: {name} ({op}) at [{PROBE_B},{PROBE_W}], {steps} "
            f"steps: kernel {e['ms']:.3f} ms, plain {e['plain_ms']:.3f} ms "
            f"(once), bound {bound_ms:.4f} ms ({bound_by}) [{card}]")
    log(f"phase 2d: {time.perf_counter() - t0:.1f} s")
    return entries


# ---------------------------------------------------------------- phase 3c


def phase3c_overlap_goldens():
    from quaff_tpu_torch.dp import ov_fill

    copy = DATA / "copy-of-c8f30.fastq"
    runs = [
        ("synth12", ["synth12.fastq", "-kmatchn", "10", "-nothreshold"],
         "synth12-overlap.oracle.stk", True),
        ("synth12 gap order 1", ["synth12.fastq", "-params",
                                 "params-gaporder1.json", "-kmatchn", "10",
                                 "-nothreshold"],
         "synth12-overlap-gap1.oracle.stk", True),
        ("c8f30 revcomp", ["c8f30.fastq.gz", str(copy), "-kmatchmb", "10"],
         "c8f30-overlap-revcomp.oracle.txt", True),
        ("c8f30 noqual", ["c8f30.fastq.gz", str(copy), "-kmatchmb", "10",
                          "-fwdstrand", "-noquals"],
         "c8f30-overlap-noqual.oracle.txt", False),
        ("c8f30 self", ["c8f30.fastq.gz", str(copy), "-kmatchmb", "10",
                        "-fwdstrand"], "c8f30-self-overlap.json", False),
    ]
    for name, args, golden, multi in runs:
        argv = ["overlap"] + [str(DATA / a) if (DATA / a).exists() else a
                              for a in args]
        before = ov_fill.ov_fill.launches
        t0 = time.perf_counter()
        out = _cli(argv, "cuda")
        dt = time.perf_counter() - t0
        n = ov_fill.ov_fill.launches - before
        check(out == (DATA / golden).read_text(),
              f"overlap {name}: output differs from {golden}")
        check(n > 0 or not multi, f"overlap {name}: K4 was not launched")
        log(f"phase 3c: overlap {name}: byte-identical to {golden}; {n} K4 "
            f"launches{'' if multi else ' (one pair: the float64 route)'}; "
            f"{dt:.2f} s")


# ---------------------------------------------------------------- phase 6


def phase6_overlap(card, n_reads=64, genome_len=100_000, n_check=8,
                   n_ref=N_REF):
    """`overlap` at a size users run, through the CLI on the card; returns
    K4's launches by route and the inputs of its largest chunk on each
    route (most in-envelope cells) and of its largest chunk of 257-512
    lanes (None where the run has none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from quaff_tpu_torch import overlap as overlap_mod
    from quaff_tpu_torch.dp import ov_fill
    from quaff_tpu_torch.dp.fill_v2 import cluster_tiling
    from quaff_tpu_torch.formats.alignment import AlignmentPrinter
    from quaff_tpu_torch.io.fastseq import add_revcomps, read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffNullParams, default_params
    from quaff_tpu_torch.overlap import QuaffOverlapAligner
    from quaff_tpu_torch.prof.kernel_sass import kernel_of

    threads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        _, rpath, head, _, _ = _workload(tmp, seed=21, n_reads=n_reads,
                                         genome_len=genome_len, n_head=n_check)
        reads = read_fast_seqs(str(rpath))
        null = tmp / "null.json"
        with open(null, "w") as f:
            QuaffNullParams.fit(reads).write_json(f)
        n_pairs = sum(2 * n_reads - 1 - nx for nx in range(n_reads - 1))

        spent: dict = {}
        chunks = []
        orig_prepare = ov_fill.prepare

        def recording(tabs, batch):
            inp = orig_prepare(tabs, batch)
            chunks.append(inp)
            return inp

        orig_pw = QuaffOverlapAligner._path_worker

        def path_worker(self, *a, **k):
            work = orig_pw(self, *a, **k)

            def timed(items):
                t0 = time.perf_counter()
                res = work(items)
                spent.setdefault("exact pass (pool thread-seconds)",
                                 []).append(time.perf_counter() - t0)
                return res

            timed.items = work.items
            return timed

        ov_fill.prepare = recording
        QuaffOverlapAligner._path_worker = path_worker
        patched = [
            _timing(spent, QuaffOverlapAligner, "_pair_jobs", "envelopes"),
            _timing(spent, QuaffOverlapAligner, "_bank", "sequence bank"),
            _timing(spent, ov_fill, "prepare", "K4 prep"),
            _timing(spent, overlap_mod, "overlap_scores",
                    "K4 prep + kernel + chunk upload"),
            _timing(spent, QuaffOverlapAligner, "_render_path", "render"),
            _timing(spent, AlignmentPrinter, "write_alignment", "write"),
        ]
        argv = ["overlap", str(rpath), "-threads", threads, "-null", str(null)]
        try:
            _reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out = _cli(argv, "cuda")
                wall = time.perf_counter() - t0
            launches = _ov_counts()
        finally:
            for owner, name, fn in reversed(patched):
                setattr(owner, name, fn)
            QuaffOverlapAligner._path_worker = orig_pw
            ov_fill.prepare = orig_prepare
        check(launches["warp_launches"] > 0,
              f"the overlap path launched no K4 on the warp route: {launches}")
        # each chunk's route and device time: K4's launches in order
        events = _kernel_events(prof, "ov_fill")
        check(len(events) == len(chunks) == launches["launches"],
              f"phase 6: {len(events)} K4 kernels traced, {len(chunks)} "
              f"chunks, launches {launches}")
        kinds = ("warp", "cluster")
        per_chunk = []
        cells = {k: 0 for k in kinds}
        dev_ms = {k: 0.0 for k in kinds}
        for inp, (kname, ms) in zip(chunks, events):
            B, W = inp["doff"].shape
            route = ov_fill.ov_route(W)
            check(kernel_of(kname) == ("ov_fill", route[0]),
                  f"phase 6: a chunk of W={W} ran {kname}, not ov_route's "
                  f"{route}")
            n = _ov_cells(inp)
            cells[route[0]] += n
            dev_ms[route[0]] += ms
            per_chunk.append((B, W, route, ms, n))
        for k in kinds:
            check(launches[f"{k}_launches"] == sum(
                r[2][0] == k for r in per_chunk),
                f"phase 6: launches by route {launches} against the chunks' "
                f"routes")
        n_aln = out.count("#=GF Score")
        check(n_aln > 0, "phase 6: reported no overlap")
        device = _device_busy(prof)
        busy = sum(device.values())
        top = sorted(device.items(), key=lambda kv: -kv[1])[:4]
        total = sum(cells.values())
        log(f"phase 6: overlap {n_reads} reads (2-10 kb, {genome_len} bp "
            f"genome), all-vs-all with reverse complements: {n_pairs} pairs "
            f"in {wall:.2f} s wall on cuda, {n_pairs / wall:.2f} pairs/s, "
            f"{n_aln} overlaps reported, K4 launches {launches} [{card}]")
        log("phase 6: K4 chunks (B, W, route, device ms, in-envelope "
            "cells): " + "; ".join(
                f"({B}, {W}, {_route_label(r)}, {ms:.3f}, {n})"
                for B, W, r, ms, n in per_chunk) + f" [{card}]")
        # the cluster route forced on each warp-route chunk (median of 3,
        # CUDA events), against the warp route timed alike
        pairs = [(_ov_time(c, r[2]), _ov_time(
            c, ("cluster", cluster_tiling(r[1], ov_fill.OV_CLUSTER_TABLE))), r)
                 for c, r in zip(chunks, per_chunk) if r[2][0] == "warp"]
        log("phase 6: warp-route chunks on both routes (B, W, lanes a "
            "thread, warp ms, cluster ms): " + "; ".join(
                f"({r[0]}, {r[1]}, {r[2][1]}, {w:.3f}, {b:.3f})"
                for w, b, r in pairs)
            + f"; all {len(pairs)}: {sum(w for w, _, _ in pairs):.3f} "
            f"against {sum(b for _, b, _ in pairs):.3f} ms [{card}]")
        # each cluster-route chunk at every tiling it can take (the route
        # table's measurement)
        for c, r in zip(chunks, per_chunk):
            if r[2][0] != "cluster":
                continue
            tilings = _sweep_tilings(r[1], ov_fill.OV_CLUSTER_LPTS,
                                     ov_fill.ov_cluster_max_warps)
            log(f"phase 6: the B={r[0]} W={r[1]} chunk at each tiling "
                f"(ms, median of 3; ov_route's {r[2][1]}): " + "; ".join(
                    "{} x {} x {}: ".format(*t)
                    + f"{_ov_time(c, ('cluster', t)):.3f}" for t in tilings)
                + f" [{card}]")
        log("phase 6: K4 by route: " + "; ".join(
            f"{k} {launches[k + '_launches']} launches, {dev_ms[k]:.3f} ms "
            f"device, {100 * cells[k] / max(total, 1):.2f}% of the "
            f"{total} in-envelope cells" for k in kinds)
            + f" [{card}]")

        def largest(pick):
            cands = [c for c, r in zip(chunks, per_chunk) if pick(r)]
            return max(cands, key=_ov_cells) if cands else None

        biggest = {k: largest(lambda r, k=k: r[2][0] == k)
                   for k in ("warp", "cluster")}
        cut = ov_fill.OV_WARP_MAX_LANES
        biggest["cutover"] = largest(lambda r: cut < r[1] <= 2 * cut)
        log("phase 6: where the time goes (host seconds, fenced by "
            "synchronize): " + "; ".join(
                f"{k} {sum(v):.3f} s in {len(v)} calls"
                for k, v in spent.items()))
        log(f"phase 6: torch.profiler: device busy {busy:.3f} s of "
            f"{wall:.3f} s wall ({100 * busy / wall:.2f}%); top: "
            + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in top)
            + f" [{card}]")

        # the first n_check reads on the CPU (plain K4), in a process of its
        # own that runs while this one holds the float64 reference
        cpu_run = subprocess.Popen(
            [sys.executable, "-m", "quaff_tpu_torch.cli", "overlap", str(head),
             "-threads", threads, "-null", str(null)],
            cwd=ROOT, env=dict(os.environ, QUAFF_TORCH_DEVICE="cpu"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        t_cpu = time.perf_counter()
        try:
            # the port's sequential float64 route on the same reads,
            # in-process: per pair one bounding-band fill with matrices, no
            # kernel pruning
            rpath_ref = tmp / f"reads{n_ref}.fastq"
            lines = rpath.read_text().splitlines()
            rpath_ref.write_text("\n".join(lines[: 4 * n_ref]) + "\n")
            out_ref_run = (out if n_ref == n_reads else _cli(
                ["overlap", str(rpath_ref), "-threads", threads, "-null",
                 str(null)], "cuda"))
            with open(null) as f:
                null_model = QuaffNullParams.from_json(f.read())
            aligner = _overlap_aligner(default_params(), null_model,
                                       threads=int(threads))
            seqs = add_revcomps(reads[:n_ref])
            buf = io.StringIO()
            printer = AlignmentPrinter()
            t0 = time.perf_counter()
            printer.write_header(buf, seqs, group_by_query=False)
            aligner._align_all_sequential(
                buf, seqs, list(aligner.enumerate_pairs(seqs, n_ref)), printer)
            t_ref = time.perf_counter() - t0
            check(buf.getvalue() == out_ref_run,
                  f"phase 6: the first {n_ref} reads' text differs from the "
                  "sequential float64 route's")
            log(f"phase 6: the first {n_ref} reads ({out_ref_run.count('#=GF Score')} "
                f"overlaps): byte-identical to the sequential float64 route "
                f"({t_ref:.1f} s in-process)")
            gpu = _cli(["overlap", str(head), "-threads", threads, "-null",
                        str(null)], "cuda")
            cpu, cpu_err = cpu_run.communicate(timeout=900)
        finally:
            if cpu_run.poll() is None:
                cpu_run.kill()
                cpu_run.wait()
        check(cpu_run.returncode == 0,
              f"phase 6: the CPU run exited {cpu_run.returncode}: "
              f"{cpu_err[-2000:]}")
        check(gpu == cpu and gpu.count("#=GF Score") > 0,
              f"phase 6: first {n_check} reads: CPU (plain K4) text differs "
              "from the GPU's")
        log(f"phase 6: first {n_check} reads on the CPU (plain K4, its own "
            f"process beside the reference): byte-identical to the GPU run, "
            f"{gpu.count('#=GF Score')} overlaps "
            f"({time.perf_counter() - t_cpu:.1f} s)")
    return launches, biggest


# ---------------------------------------------------------------- phase 7


def _free_ports(n):
    """The first of n consecutive ports that are free on this host."""
    import socket

    for _ in range(100):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            for q in range(port + 1, port + n):
                with socket.socket() as s:
                    s.bind(("", q))
            return port
        except OSError:
            continue
    raise SmokeFailure(f"no {n} consecutive free ports")


class _Served:
    """`server <argv>` of the port in a thread of this process, on the card,
    while the with block runs: its "# READY" goes to a buffer (this
    script's stdout stays its own), and at the end every port it serves is
    sent {"quit": 1}."""

    def __init__(self, argv):
        self.argv = argv

    def __enter__(self):
        import threading
        from collections import deque

        from quaff_tpu_torch.server import READY, server_from_args

        self.server, _, _ = server_from_args(deque(self.argv), {})
        check(self.server.device.type == "cuda",
              f"server {self.argv[0]} resolved {self.server.device}")
        self.port = _free_ports(self.server.n_ports)
        ready = io.StringIO()
        self.thread = threading.Thread(
            target=self.server.serve, args=(self.port, self.server.n_ports),
            kwargs={"ready_out": ready}, daemon=True)
        self.thread.start()
        t0 = time.perf_counter()
        while READY not in ready.getvalue():
            check(self.thread.is_alive() and time.perf_counter() - t0 < 60,
                  f"server {self.argv[0]} did not report READY")
            time.sleep(0.01)
        return self

    @property
    def address(self):
        last = self.port + self.server.n_ports - 1
        return f"127.0.0.1:{self.port}" + (
            f"-{last}" if last > self.port else "")

    def __exit__(self, *exc):
        from quaff_tpu_torch.server import RemoteWorker

        for p in range(self.port, self.port + self.server.n_ports):
            RemoteWorker("127.0.0.1", p).quit()
        self.thread.join(timeout=30)
        check(not self.thread.is_alive(),
              f"server {self.argv[0]} did not stop on quit")
        return False


def _read_blocks(text):
    """{read name: its block} of Stockholm align text (a block from its
    "# STOCKHOLM" line to its "//" line, one a read without -printall)."""
    blocks = {}
    for b in re.split(r"(?m)^//\n", text)[:-1]:
        name = re.search(r"(?m)^#=GS CC Read (.*)$", b).group(1)
        check(name not in blocks, f"two blocks for read {name}")
        blocks[name] = b + "//\n"
    check("".join(blocks.values()) == text, "align text is not whole blocks")
    return blocks


def _timed_requests(waits):
    """Patches RemoteWorker.request to add each request's wall seconds to
    `waits` (the client's view: send, the server's job, the reply); returns
    what restores it."""
    from quaff_tpu_torch import server

    orig = server.RemoteWorker.request

    def timed(self, payload):
        t0 = time.perf_counter()
        reply = orig(self, payload)
        waits.append(time.perf_counter() - t0)
        return reply

    server.RemoteWorker.request = timed
    return lambda: setattr(server.RemoteWorker, "request", orig)


def _request_stats(waits):
    qs = statistics.quantiles(waits, n=10)
    return (f"{len(waits) / sum(waits):.2f} requests/s over {len(waits)} "
            f"back to back, per request median {statistics.median(waits) * 1e3:.1f} "
            f"ms, p90 {qs[8] * 1e3:.1f} ms")


def _refill_cells(gpath, rpath, origins):
    """Cells of each read's float64 refill in a `server align` job (its
    true strand's whole envelope: rows + 1 times the bounding band), at
    `align`'s default k-mer threshold."""
    from quaff_tpu_torch.aligner import VITERBI_CELL_SIZE, DPConfig
    from quaff_tpu_torch.cliargs import DEFAULT_REFSEQ_KMER_THRESHOLD
    from quaff_tpu_torch.io.fastseq import KmerIndex, read_fast_seqs

    cfg = DPConfig(kmer_threshold=DEFAULT_REFSEQ_KMER_THRESHOLD, device="cpu")
    x = read_fast_seqs(str(gpath))[0]
    strands = (x, x.revcomp())
    return [(len(y.seq) + 1) * cfg.make_envelope(
                strands[rev], KmerIndex(y, cfg.kmer_len),
                VITERBI_CELL_SIZE).band_width
            for y, (_, _, rev) in zip(read_fast_seqs(str(rpath)), origins)]


def _server_k1_cases(calls, card):
    """The server path's K1 launches at the widest band, at the most rows
    and the widest on each route taken, each against the plain version on
    its recorded inputs (fill_case: phase 2's tolerance, a rerun bit for
    bit, times, the bound).  Returns {route: the fill_case result of the
    route's widest case, its "max_abs_err" the worst of the route's
    cases}."""
    n = range(len(calls.calls))
    width = lambda i: calls.calls[i][1]
    picks = {max(n, key=width): "the widest band"}
    picks.setdefault(max(n, key=lambda i: calls.inputs[i]["keys"].shape[1]),
                     "the most rows")
    for r in sorted({c[0][0] for c in calls.calls}):
        picks.setdefault(max((i for i in n if calls.calls[i][0][0] == r),
                             key=width), f"the widest on the {r} route")
    by_route = {}
    for i, why in sorted(picks.items()):
        kw = calls.inputs[i]
        inp = {k: kw[k] for k in ("x_tok", "keys", "meta", "doff",
                                  "seg_start", "seg_width")}
        got = fill_case(f"phase 7 (a): a job's launch, {why}", inp,
                        kw["tables"], kw["mode"], kw["local"], card,
                        mp=kw["max_prop"], n_plain=1)
        by_route.setdefault(got["route"][0], []).append((width(i), got))
    return {r: dict(max(cs, key=lambda c: c[0])[1],
                    max_abs_err=max(c[1]["max_abs_err"] for c in cs))
            for r, cs in by_route.items()}


def phase7_server(card, n_align=128, n_count=1, n_overlap=8, n_launch=2,
                  n_profile=8, genome_len=12_000):
    """`server` and the remote, ssh and qsub backends on the card: the
    port's `server align` in a thread here, `align -remote` against it on
    phase 4's reads against a `genome_len` genome (byte for byte the local
    align; K1 launched by the server's jobs, each on fill_route's route,
    and held against its plain version), the same with two ports, `server
    count` and `count -remote` on phase 5's first reads, `server overlap`
    and `overlap -remote` on phase 6's, an ssh-launched (stub ssh) and a
    qsub (/bin/sh) align, and `align -profile`.  Returns K1's launches on
    the server path by route, and _server_k1_cases's results."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from quaff_tpu_torch.aligner import DPConfig
    from quaff_tpu_torch.cliargs import DEFAULT_REFSEQ_KMER_THRESHOLD
    from quaff_tpu_torch.io.fastseq import read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffNullParams, default_params
    from quaff_tpu_torch.prof.kernel_sass import kernel_of
    from quaff_tpu_torch.trainer import QuaffCounter

    t_phase = time.perf_counter()
    threads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        # what an align job's float64 refill of the whole envelope costs on
        # phase 4's 200 kb genome: random 6-mer seeds make distant clusters
        # in every read's envelope, so its bounding band spans much of the
        # genome
        (tmp / "phase4").mkdir()
        g4, r4, _, _, o4 = _workload(tmp / "phase4", n_reads=16,
                                     genome_len=200_000, n_head=1)
        cells4 = _refill_cells(g4, r4, o4)
        log(f"phase 7: an align job's refill on phase 4's first 16 reads "
            f"(200 kb genome) would fill {sum(cells4):.4g} cells, up to "
            f"{max(cells4):.4g} for one read "
            f"({24 * max(cells4) / 2**30:.1f} GiB of float64 matrices); "
            f"phase 7 cuts the genome to {genome_len // 1000} kb")
        # (a) phase 4's recipe and first reads against a genome_len genome,
        # with their null model
        gpath, rpath, head, _, origins = _workload(
            tmp, n_reads=n_align, genome_len=genome_len, n_head=n_launch)
        cells = _refill_cells(gpath, rpath, origins)
        null = tmp / "null.json"
        with open(null, "w") as f:
            QuaffNullParams.fit(read_fast_seqs(str(rpath))).write_json(f)
        base = [str(gpath), str(rpath), "-null", str(null)]
        t0 = time.perf_counter()
        local = _cli(["align", *base, "-threads", threads], "cuda")
        t_local = time.perf_counter() - t0
        check(local.count("#=GF Score") >= 0.9 * n_align,
              f"phase 7: local align aligned {local.count('#=GF Score')} of "
              f"{n_align} reads")
        waits = []
        with _Served(["align", *base]) as srv:
            calls = _record_fill()
            restore = _timed_requests(waits)
            try:
                with calls, profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    remote = _cli(["align", *base, "-remote", srv.address],
                                  "cuda")
                    wall = time.perf_counter() - t0
            finally:
                restore()
        check(remote == local, "phase 7 (a): align -remote differs from the "
              "local align")
        counts = calls.counts
        check(len(waits) == n_align and counts["launches"] >= n_align,
              f"phase 7 (a): {len(waits)} requests, K1 launches {counts}")
        events = _kernel_events(prof, "band_fill")
        check(len(events) == counts["launches"],
              f"phase 7 (a): {len(events)} K1 kernels traced, {counts}")
        for (kname, _), (r, W, B, _) in zip(events, calls.calls):
            check(kernel_of(kname) == ("band_fill", r[0]),
                  f"phase 7 (a): a job's B={B} W={W} batch on fill_route's "
                  f"{r} ran {kname}")
        k1_ms = sum(ms for _, ms in events)
        busy = sum(_device_busy(prof).values())
        widths = sorted(W for _, W, _, _ in calls.calls)
        log(f"phase 7 (a): align -remote against server align on cuda, "
            f"{n_align} reads: byte-identical to the local align "
            f"({t_local:.2f} s); {wall:.2f} s wall, {_request_stats(waits)}; "
            f"K1 {counts['launches']} launches (warp "
            f"{counts['warp_launches']}, cluster {counts['cluster_launches']}, "
            f"block {counts['block_launches']}; W {widths[0]}-{widths[-1]}), "
            f"{k1_ms:.3f} ms device (torch.profiler); device busy "
            f"{busy:.3f} s ({100 * busy / wall:.2f}% of the wall); the "
            f"jobs' float64 refills {sum(cells):.4g} cells, up to "
            f"{max(cells):.4g} a read [{card}]")
        server_counts = dict(counts)
        k1_cases = _server_k1_cases(calls, card)
        del calls

        # (b) two ports, two client workers: replies in arrival order
        waits2 = []
        with _Served(["align", *base, "-threads", "2"]) as srv:
            calls = _record_fill()
            restore = _timed_requests(waits2)
            try:
                with calls:
                    t0 = time.perf_counter()
                    two = _cli(["align", *base, "-remote", srv.address],
                               "cuda")
                    wall2 = time.perf_counter() - t0
            finally:
                restore()
        mine, blocks_a = _read_blocks(two), _read_blocks(local)
        check(sorted(mine.values()) == sorted(blocks_a.values()),
              "phase 7 (b): the two-port run's blocks differ from (a)'s")
        check(calls.counts["launches"] >= n_align,
              f"phase 7 (b): K1 launches {calls.counts}")
        log(f"phase 7 (b): server align -threads 2, two client workers: the "
            f"same {len(mine)} blocks as (a) in reply order; {wall2:.2f} s "
            f"wall, {len(waits2) / wall2:.2f} requests/s, per request median "
            f"{statistics.median(waits2) * 1e3:.1f} ms; K1 "
            f"{calls.counts['launches']} launches [{card}]")
        del calls

        # (c) count: phase 5's first n_count reads, each against its genome
        # window (+-200 bp, its strand; the exact engine fills a pair's
        # bounding band).  `server count` loads reads without qualities, as
        # the JAX package's does (quaff_tpu/server.py:293-296), and counts
        # in float64 by the exact engine on its device: held to the plain
        # count (float64, the host) of the reads without qualities, through
        # the wire's 6 significant figures.  The engine on the card is
        # launch-bound (its launches a row are measured below): 16 reads
        # would take minutes
        ctmp = tmp / "count"
        ctmp.mkdir()
        _, crpath, _, genome, origins = _workload(
            ctmp, seed=2, n_reads=n_count, genome_len=200_000, n_head=1)
        acgt = np.frombuffer(b"ACGT", np.uint8)
        lines = crpath.read_text().splitlines()
        t_remote = t_plain = 0.0
        worst = 0.0
        picked = range(n_count)
        for i in picked:
            s0, n, rev = origins[i]
            w = genome[max(s0 - 200, 0):s0 + n + 200]
            if rev:
                w = (3 - w)[::-1]
            wpath, ypath = ctmp / f"window{i}.fasta", ctmp / f"read{i}.fastq"
            wpath.write_text(f">window{i}\n{acgt[w].tobytes().decode()}\n")
            ypath.write_text("\n".join(lines[4 * i:4 * i + 4]) + "\n")
            args = [str(wpath), str(ypath), "-fwdstrand"]
            t1 = time.perf_counter()
            with _Served(["count", *args]) as srv:
                got = json.loads(_cli(["count", *args, "-remote", srv.address],
                                      "cuda"))
            t_remote += time.perf_counter() - t1
            t1 = time.perf_counter()
            refs, reads = read_fast_seqs(str(wpath)), read_fast_seqs(str(ypath))
            nullm = QuaffNullParams.fit(reads)  # the client's, as sent
            for q in refs + reads:
                q.qual = ""
            cfg = DPConfig(kmer_threshold=DEFAULT_REFSEQ_KMER_THRESHOLD,
                           device="cpu")
            plain, _, _ = QuaffCounter(default_params(), nullm, cfg).get_counts(
                refs, reads)
            buf = io.StringIO()
            plain.write_json(buf)
            t_plain += time.perf_counter() - t1
            want = json.loads(buf.getvalue())
            bad = _json_close(got, want, 1e-5, 1e-6)
            check(not bad, f"phase 7 (c): count -remote vs the plain count, "
                           f"read {i}: {bad[:5]}")
            worst = max(worst, max(
                abs(float(a) - float(b)) / (1e-6 + 1e-5 * abs(float(b)))
                for a, b in _json_pairs(got, want)))
        log(f"phase 7 (c): count -remote against server count on cuda, each "
            f"of {n_count} reads (of {[origins[i][1] for i in picked]} bp) "
            f"against its genome window: within 1e-6 + "
            f"1e-5*|x| of the plain float64 count (worst {worst:.3f} of the "
            f"tolerance); remote {t_remote:.1f} s, plain {t_plain:.1f} s")
        _count_engine_launches(refs, reads, nullm, card)

        # (d) overlap: phase 6's first reads, all against all
        otmp = tmp / "overlap"
        otmp.mkdir()
        _, orpath, _, _, _ = _workload(otmp, seed=21, n_reads=n_overlap,
                                       genome_len=100_000, n_head=1)
        onull = otmp / "null.json"
        with open(onull, "w") as f:
            QuaffNullParams.fit(read_fast_seqs(str(orpath))).write_json(f)
        obase = [str(orpath), "-null", str(onull)]
        t0 = time.perf_counter()
        olocal = _cli(["overlap", *obase, "-threads", threads], "cuda")
        with _Served(["overlap", *obase]) as srv:
            oremote = _cli(["overlap", *obase, "-remote", srv.address], "cuda")
        check(oremote == olocal and olocal.count("#=GF Score") > 0,
              "phase 7 (d): overlap -remote differs from the local overlap")
        log(f"phase 7 (d): overlap -remote against server overlap on cuda, "
            f"{n_overlap} reads ({olocal.count('#=GF Score')} overlaps): "
            f"byte-identical to the local overlap "
            f"({time.perf_counter() - t0:.1f} s)")

        # (e) an ssh-launched worker (a stub ssh runs the worker command
        # here: a `server align` process on the card) and qsub through
        # /bin/sh (a `server align -job` process a read)
        t0 = time.perf_counter()
        stub = tmp / "fake-ssh"
        stub.write_text("#!/bin/sh\nfor last; do :; done\n"
                        'exec sh -c "$last"\n')
        stub.chmod(0o755)
        names = [ln[1:] for ln in head.read_text().splitlines()[::4]]
        want = "".join(blocks_a[nm] for nm in names if nm in blocks_a)
        hbase = [str(gpath), str(head), "-null", str(null)]
        ssh = _cli(["align", *hbase, "-remote",
                    f"tester@127.0.0.1:{_free_ports(1)}", "-sshpath",
                    str(stub)], "cuda")
        check(ssh == want, "phase 7 (e): the ssh-launched worker's text "
                           "differs from (a)'s")
        qsub = _cli(["align", *hbase, "-qsubjobs", "1", "-qsubpath", "/bin/sh",
                     "-qsubdir", str(tmp / "jobs")], "cuda")
        check(qsub == want, "phase 7 (e): the qsub run's text differs from "
                            "(a)'s")
        log(f"phase 7 (e): align through an ssh-launched server (stub ssh) "
            f"and through qsub (/bin/sh), {n_launch} reads each: "
            f"byte-identical to (a)'s ({time.perf_counter() - t0:.1f} s)")

        # (f) -profile: a Chrome trace holding K1's kernels by name
        ppath = tmp / f"reads{n_profile}.fastq"
        ppath.write_text("\n".join(
            rpath.read_text().splitlines()[:4 * n_profile]) + "\n")
        _cli(["align", str(gpath), str(ppath), "-null", str(null), "-profile",
              str(tmp / "trace")], "cuda")
        traces = list((tmp / "trace").glob("quaff-align-*.trace.json"))
        check(len(traces) == 1, f"phase 7 (f): traces {traces}")
        kevents = [e for e in json.loads(traces[0].read_text())["traceEvents"]
                   if e.get("cat") == "kernel"]
        k1 = [e for e in kevents
              if (kernel_of(e.get("name", "")) or ("",))[0] == "band_fill"]
        check(k1, f"phase 7 (f): no K1 kernel in the trace's "
                  f"{len(kevents)} kernel events")
        log(f"phase 7 (f): align -profile on {n_profile} reads: "
            f"{traces[0].name} holds {len(k1)} K1 kernel events of "
            f"{len(kevents)} kernels ({sum(e.get('dur', 0) for e in k1) / 1e3:.3f} ms)")
    log(f"phase 7: {time.perf_counter() - t_phase:.1f} s")
    return server_counts, k1_cases


def _count_engine_launches(refs, reads, nullm, card, n_rows=200):
    """Why a count job is slow on the card: the exact engine (float64, the
    path of a read without qualities) on the first n_rows bases of the
    last read against the start of its window, on cuda under
    torch.profiler (kernels launched a row, device busy share) and on the
    host (its wall, for the ratio)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from quaff_tpu_torch.aligner import DPConfig
    from quaff_tpu_torch.cliargs import DEFAULT_REFSEQ_KMER_THRESHOLD
    from quaff_tpu_torch.io.fastseq import FastSeq
    from quaff_tpu_torch.model.params import default_params
    from quaff_tpu_torch.trainer import QuaffCounter

    x = FastSeq(name="window", seq=refs[0].seq[:n_rows + 400])
    y = FastSeq(name="read", seq=reads[0].seq[:n_rows])
    walls = {}
    for dev in ("cuda", "cpu"):
        counter = QuaffCounter(default_params(), nullm, DPConfig(
            kmer_threshold=DEFAULT_REFSEQ_KMER_THRESHOLD, device=dev))
        counter.count_read([x], y, [0])  # warm
        with profile(activities=[ProfilerActivity.CPU]
                     + [ProfilerActivity.CUDA] * (dev == "cuda")) as prof:
            t0 = time.perf_counter()
            counter.count_read([x], y, [0])
            walls[dev] = time.perf_counter() - t0
        if dev == "cuda":
            n_kernels = sum(e.device_type == DeviceType.CUDA
                            for e in prof.events())
            busy = sum(_device_busy(prof).values())
    log(f"phase 7 (c): the exact engine on {n_rows} rows: on cuda "
        f"{n_kernels} device events, kernels and copies "
        f"({n_kernels / n_rows:.0f} a row), "
        f"{1e3 * walls['cuda'] / n_rows:.3f} ms a row, device busy "
        f"{100 * busy / walls['cuda']:.2f}% of the wall (torch.profiler); "
        f"on the host {1e3 * walls['cpu'] / n_rows:.3f} ms a row (the card "
        f"takes {walls['cuda'] / walls['cpu']:.2f}x the host's time) [{card}]")


def _json_pairs(a, b):
    """(a's number, b's) of every number of two JSON documents alike in
    shape."""
    if isinstance(a, dict):
        for k in a:
            yield from _json_pairs(a[k], b[k])
    elif isinstance(a, list):
        for u, v in zip(a, b):
            yield from _json_pairs(u, v)
    elif isinstance(a, (int, float)):
        yield a, b


def main() -> int:
    if not (ROOT / "quaff_tpu_torch").is_dir():
        sys.stderr.write("chip_smoke.py: run it from a checkout of the "
                         "repository (quaff_tpu_torch/ not found)\n")
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke.py: torch.cuda.is_available() is false; "
                         "this check needs one CUDA card\n")
        return 1
    t_start = time.perf_counter()
    card = phase0_card()
    phase1_build()
    k1 = phase2_kernel(card)
    phase2b_estep(card)
    phase2c_overlap_kernel(card)
    probes = phase2d_sol_probes(card)
    phase3_goldens()
    block_launches, wide = phase3b_train_goldens(card)
    # K2's and K3's block routes at the chunk of their path (count -fast
    # -kmatchband 600), against their plain versions
    estep_block = estep_case("phase 3b: the -kmatchband 600 chunk",
                             wide["batch"], wide["v2"], wide["local"], card)
    check(all(set(estep_block[k]) == {"block"} for k in ESTEP),
          "the -kmatchband 600 chunk is narrow enough for a warp route")
    del wide
    phase3c_overlap_goldens()
    k1_counts, k1_chunk = phase4_workload(card)
    check(k1_counts["cluster_launches"] > 0 and k1_chunk is not None,
          f"phase 4: the align path launched no K1 on the cluster route: "
          f"{k1_counts}")
    # the cluster route at the align path's largest cluster-route chunk,
    # the block route forced beside it and the other tilings of the sweep
    # timed alike; its plain version once (tens of seconds)
    inp = {k: k1_chunk[k] for k in ("x_tok", "keys", "meta", "doff",
                                    "seg_start", "seg_width")}
    k1_wide = fill_case("phase 4: the largest cluster-route chunk", inp,
                        k1_chunk["tables"], k1_chunk["mode"],
                        k1_chunk["local"], card, route="cluster",
                        mp=k1_chunk["max_prop"], n_plain=1,
                        also=(("block", 0),))
    log(f"phase 4: the largest cluster-route chunk: cluster route "
        f"{k1_wide['ms']:.3f} ms against the block route's "
        f"{k1_wide['also']['block route']:.3f} ms "
        f"({k1_wide['also']['block route'] / k1_wide['ms']:.2f}x) [{card}]")
    del inp, k1_chunk
    k1_block_counts, k1_block = phase4b_kmatchoff(card)
    launches, chunk = phase5_train(card)
    # K2, K3 and the reduction at the shape of the train path's largest
    # chunk, against their plain versions (timed once: minutes otherwise),
    # each of K2's and K3's routes forced on the same inputs
    estep_k = estep_case("phase-5 chunk", chunk["batch"], chunk["v2"],
                         chunk["local"], card, n_plain=1)
    check(all(set(estep_k[k]) == {"warp", "block"} for k in ESTEP),
          "the phase-5 chunk is too wide for the warp routes")
    del chunk
    k4_launches, k4_chunks = phase6_overlap(card)
    from quaff_tpu_torch.dp import fill_v2, ov_fill
    from quaff_tpu_torch.dp.fill_v2 import cluster_tiling

    # K4 at the overlap path's largest warp-route chunk (the warp route;
    # the cluster route forced on the same inputs), its plain version on
    # the chunk's first 128 pairs (a whole chunk is minutes)
    W = k4_chunks["warp"]["doff"].shape[1]
    k4 = ov_case("phase 6: the largest warp-route chunk", k4_chunks["warp"],
                 card, n_plain=128, routes=(
                     None, ("cluster",
                            cluster_tiling(W, ov_fill.OV_CLUSTER_TABLE))))
    log(f"phase 6: the largest warp-route chunk, first 128 pairs: warp route "
        f"{k4[0]['ms']:.3f} ms, cluster route {k4[1]['ms']:.3f} ms "
        f"({k4[1]['ms'] / k4[0]['ms']:.2f}x); whole chunk "
        f"{k4[0]['full']['ms']:.3f} / {k4[1]['full']['ms']:.3f} ms [{card}]")
    # the cluster route at the path's largest cluster-route chunk, its
    # plain version on the chunk's last 4 pairs (the fewest rows)
    k4_cl = ov_case("phase 6: the largest cluster-route chunk",
                    k4_chunks["cluster"], card, n_plain=4, last=True)[0]
    # the warp route's cutover: the warp route forced on the same chunk of
    # OV_WARP_MAX_LANES + 1 to twice as many lanes, against the cluster
    # route
    if k4_chunks["cutover"] is not None:
        B, W = k4_chunks["cutover"]["doff"].shape
        lpt = next(n for n in fill_v2.WARP_LPTS if 32 * n >= W)
        warp, clu = ov_case(f"phase 6: the {ov_fill.OV_WARP_MAX_LANES + 1}-"
                            f"{2 * ov_fill.OV_WARP_MAX_LANES}-lane chunk",
                            k4_chunks["cutover"], card, n_plain=2, last=True,
                            routes=(("warp", lpt), None))
        log(f"phase 6: the warp route's cutover: at B={B} W={W}, {lpt} lanes "
            f"a thread {warp['full']['ms']:.3f} ms against the cluster "
            f"route's {clu['full']['ms']:.3f} ms "
            f"({clu['full']['ms'] / warp['full']['ms']:.2f}x); "
            f"OV_WARP_MAX_LANES is {ov_fill.OV_WARP_MAX_LANES} [{card}]")
    del k4_chunks
    k1_server_counts, k1_server = phase7_server(card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    k1_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = [dict(name="band_fill", route="cuda",
                    source="quaff_tpu_torch/csrc/band_fill_warp.cuh",
                    replaces="quaff_tpu/dp/pallas_v2.py:491",
                    launches=k1_counts["warp_launches"], library_ms=None,
                    **{k: k1[k] for k in k1_keys}),
               dict(name="band_fill_cluster", route="cuda",
                    source="quaff_tpu_torch/csrc/band_fill_cluster.cuh",
                    replaces="quaff_tpu/dp/pallas_v2.py:491",
                    launches=k1_counts["cluster_launches"], library_ms=None,
                    **{k: k1_wide[k] for k in k1_keys}),
               dict(name="band_fill_block", route="cuda",
                    source="quaff_tpu_torch/csrc/band_fill.cuh",
                    replaces="quaff_tpu/dp/pallas_v2.py:491",
                    launches=k1_block_counts["block_launches"],
                    library_ms=None, **{k: k1_block[k] for k in k1_keys})]
    # K1 on the server's path (phase 7 (a)'s align jobs), a row per route
    # its jobs took
    for r, res in sorted(k1_server.items()):
        kernels.append(dict(
            name=f"band_fill{'' if r == 'warp' else '_' + r}_server",
            route="cuda", source=f"quaff_tpu_torch/csrc/band_fill"
            f"{'' if r == 'block' else '_' + r}.cuh",
            replaces="quaff_tpu/dp/pallas_v2.py:491",
            launches=k1_server_counts[f"{r}_launches"], library_ms=None,
            **{k: res[k] for k in k1_keys}))
    # K2 and K3: the warp routes on phase 5's path (train), timed on its
    # largest chunk; the block routes on phase 3b's count -fast with a
    # band wider than any warp route, timed on that run's chunk
    e_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")
    for name, rep_at, block_src in (
            ("fwd_store", "quaff_tpu/dp/pallas_counts.py:507",
             "quaff_tpu_torch/csrc/band_fill.cuh"),
            ("bwd_counts", "quaff_tpu/dp/pallas_counts.py:561",
             "quaff_tpu_torch/csrc/estep.cu")):
        for suffix, source, n, kind, res in (
                ("", "quaff_tpu_torch/csrc/estep_warp.cuh",
                 launches[name]["warp_launches"], "warp", estep_k),
                ("_block", block_src, block_launches[name]["block_launches"],
                 "block", estep_block)):
            check(n > 0, f"{name}'s {kind} route was not launched on its path")
            kernels.append(dict(name=name + suffix, route="cuda",
                                source=source, replaces=rep_at, launches=n,
                                **{k: res[name][kind][k] for k in e_keys}))
    kernels.append(dict(name="estep_reduce", route="cuda",
                        source="quaff_tpu_torch/csrc/estep.cu",
                        replaces="quaff_tpu/dp/pallas_counts.py:561",
                        launches=launches["estep_reduce"]["launches"],
                        **estep_k["estep_reduce"]))
    k4_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")
    for name, source, n, res in (
            ("ov_fill", "quaff_tpu_torch/csrc/ov_fill_warp.cuh",
             k4_launches["warp_launches"], k4[0]),
            ("ov_fill_cluster", "quaff_tpu_torch/csrc/ov_fill_cluster.cuh",
             k4_launches["cluster_launches"], k4_cl)):
        check(n > 0, f"{name} was not launched on phase 6's path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces="quaff_tpu/dp/pallas_overlap.py:221",
                            launches=n, **{k: res[k] for k in k4_keys}))
    kernels += probes
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
