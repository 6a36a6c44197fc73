#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (quaff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

It builds everything from the checkout and runs its phases in order; any
failure exits non-zero before the final line is printed.

  0  the card's name and power limit (nvidia-smi), torch and CUDA versions
  1  build the kernels (quaff_tpu_torch/csrc/*.cu, one nvcc per source,
     sm_90a) and the host library libquaffio (native/*.cpp, one g++ per
     source), both at once
  2  K1 against its plain PyTorch version on the card: c8f30 against itself
     lane-packed at B=2048 (the align configuration), plus forward, global,
     no-quality, gap-order-1 and a band wider than shared memory; median
     times of both, in-envelope cells/s, the least time the card could take
  2b K2, K3 and the count reduction against their plain versions: B=64
     W~134 Ly=300 at gap order 0 and 1, global mode, a band wider than
     shared memory, and the c8f30 self pair; two runs must give
     bit-identical count tables
  3  the port's `align` CLI on cuda, byte for byte against four goldens,
     with K1 launched in each run
  3b `train` on c8f30 (2 EM iterations) through K2/K3 against the golden
     log-likelihoods and c8f30-train2.oracle.json; `count -fast` on
     synth12 against the float64 parity count
  4  align at a size users run: a seeded 200 kb genome and 1024 reads of
     2-10 kb (12% substitutions and indels, half reverse strand, with
     qualities) through the CLI on cuda; reads/s and K1 launches; the first
     32 reads again on the CPU (plain version) must give the same text
  5  train at a size users run: 256 such reads, `train -maxiter 2` through
     the CLI on cuda; s per EM iteration, pair fills, K2/K3 launches, peak
     device memory; the log-likelihood must rise; `count -fast` on the
     first 16 reads against the parity count; then K2/K3 and the reduction
     on the run's largest chunk against their plain versions

Each path (phase 4 for K1, phase 5 for K2, K3 and the reduction) runs with
the launch counts set to 0 just before it and read just after.
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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    card = smi[0].strip()
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
    log(f"phase 1: kernel library (K1, K2, K3, reduce) {how} in {t_cuda:.1f} s "
        f"({kernels.library_path().relative_to(ROOT)})")
    for line in (kernels.build_log or "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
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


def _compare(got, ref):
    """max |kernel - plain| over finite entries; fails outside tolerance."""
    import torch

    floor = -3.4028234663852886e38 / 2
    g = torch.where(got <= floor, float("-inf"), got).double().cpu()
    r = torch.where(ref <= floor, float("-inf"), ref).double().cpu()
    check(torch.equal(torch.isfinite(g), torch.isfinite(r)),
          "kernel and plain version disagree on which scores are -inf")
    fin = torch.isfinite(r)
    check(bool(fin.any()), "no finite score to compare")
    err = (g[fin] - r[fin]).abs()
    bad = err > ATOL + RTOL * r[fin].abs()
    check(not bool(bad.any()),
          f"kernel vs plain outside rtol {RTOL} / atol {ATOL}: max abs err "
          f"{float(err.max()):.3g}")
    return float(err.max())


def _time(fn, variants):
    """Median seconds of fn(v) over distinct inputs, by CUDA events around
    each call (a plain version's host-side launch gaps count too)."""
    import torch

    times = []
    for v in variants:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn(v)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return statistics.median(times)


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


def _cells(inp):
    """In-envelope cells of a kernel_inputs batch: for each lane, the rows
    j = 1..ylen whose ref index doff + j - 1 lies in [0, xlen)."""
    import torch

    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    d = inp["doff"].long()
    xlen, ylen = inp["meta"][:, 0:1].long(), inp["meta"][:, 1:2].long()
    n = torch.minimum(ylen, xlen - d) - torch.clamp(1 - d, min=1) + 1
    n = torch.where(inp["doff"] != D_SENTINEL, n.clamp(min=0), 0)
    return int(n.sum())


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


def run_case(name, pb, tables, mode, local, card, n_runs=3):
    """K1 and its plain version on one batch: agreement and times."""
    import torch

    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.dp.engine import to_device

    v2 = fill_v2.V2Tables.from_tables(tables, "cuda")
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    mp = fill_v2.batch_max_prop(pb)

    def kern(keys):
        return fill_v2.band_fill(**dict(inp, keys=keys), tables=v2, mode=mode,
                                 local=local)

    def plain(keys):
        return fill_v2.band_fill_reference(**dict(inp, keys=keys), tables=v2,
                                           mode=mode, local=local, max_prop=mp)

    got = kern(inp["keys"])
    torch.cuda.synchronize()
    ref = plain(inp["keys"])
    err = _compare(got, ref)
    # distinct inputs per timed run: one quality value changed per variant
    variants = []
    for i in range(n_runs + 1):
        k = inp["keys"].clone()
        k[:, i % k.shape[1], 1] = (k[:, i % k.shape[1], 1] + 1) % 40
        variants.append(k)
    kern(variants[0])  # warm
    ms = _time(kern, variants[1:]) * 1e3
    plain_ms = _time(plain, variants[1:]) * 1e3
    B, W = inp["doff"].shape
    cells = _cells(inp)
    bound_ms, bound_by = _bound(
        _fill_in_bytes(inp, v2) + 4 * B * (1 + inp["seg_start"].shape[1]),
        OPS_PER_CELL[mode] * cells)
    log(f"phase 2: {name}: B={B} W={W} Ly={inp['keys'].shape[1]} {mode} "
        f"{'local' if local else 'global'}: max abs err {err:.3g}; "
        f"K1 {ms:.3f} ms, plain {plain_ms:.3f} ms (median of {n_runs}); "
        f"{cells} in-envelope cells, bound {bound_ms:.4f} ms ({bound_by}) "
        f"[{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "cells": cells}


def phase2_kernel(card):
    import numpy as np
    import torch

    from quaff_tpu_torch import kernels
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
    main = run_case("c8f30 packed", pb, tables, "viterbi", True, card)
    cells = main["cells"]
    log(f"phase 2: c8f30 packed: K1 {cells / (main['ms'] / 1e3):.4g} cells/s, "
        f"plain {cells / (main['plain_ms'] / 1e3):.4g} cells/s [{card}]")

    rng = np.random.default_rng(7)
    pairs = _synthetic_pairs(rng, 64)
    run_case("forward", PairBatch.build_packed(pairs, tables), tables,
             "forward", True, card)
    # global paths need the whole ref in the band: full envelopes (W above
    # 1024 lanes, so each thread of the kernel owns two lanes)
    run_case("global", PairBatch.build(
        [(xg, yg, full_envelope(len(xg.seq), len(yg.seq)))
         for xg, yg, _ in pairs[:16]], tables), tables, "viterbi", False, card)
    run_case("no-qual", PairBatch.build_packed(
        _synthetic_pairs(rng, 64, with_qual=False), tables), tables,
        "viterbi", True, card)
    gap1 = ScoreTables.from_params(QuaffParams.from_json(
        (DATA / "params-gaporder1.json").read_text()))
    run_case("gaporder1", PairBatch.build_packed(pairs, gap1), gap1,
             "viterbi", True, card)
    # a band wider than the block's shared memory: row state in global
    # scratch
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
    check(wpb.member.shape[1] > limit, "wide case fits shared memory")
    run_case(f"wide (W > {limit} smem lanes)", wpb, tables, "viterbi", True,
             card)
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


def phase4_workload(card, n_reads=1024, genome_len=200_000, n_check=32):
    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.io.fastseq import read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffNullParams

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
        fill_v2.band_fill.launches = 0
        t0 = time.perf_counter()
        out = _cli(argv, "cuda")
        wall = time.perf_counter() - t0
        launches = fill_v2.band_fill.launches
        check(launches > 0, "the main path launched no K1")
        n_aligned = out.count("#=GF Score")
        check(n_aligned >= 0.9 * n_reads,
              f"only {n_aligned} of {n_reads} reads aligned")
        log(f"phase 4: align on cuda: {wall:.2f} s wall, "
            f"{n_reads / wall:.2f} reads/s, {n_aligned} alignments, "
            f"{launches} K1 launches [{card}]")
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
    return launches


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


def estep_case(name, bdev, v2, local, card, n_plain=3, n_runs=3):
    """K2, K3 and the count reduction against their plain versions on one
    batch: agreement, bitwise repeatability, times and bounds."""
    import torch

    from quaff_tpu_torch.dp import estep, fill_v2

    inp = fill_v2.kernel_inputs(bdev)
    mp = _max_prop(bdev)
    B, W = inp["doff"].shape
    Ly = inp["keys"].shape[1]

    def k2(keys):
        return estep.fwd_store(**dict(inp, keys=keys), tables=v2, local=local)

    def p2(keys):
        return estep.fwd_store_reference(**dict(inp, keys=keys), tables=v2,
                                         local=local, max_prop=mp)

    fwd, rows, offs = k2(inp["keys"])
    torch.cuda.synchronize()
    err_f = _compare(fwd, p2(inp["keys"])[0])
    fin = fwd > fill_v2.NEG_INF / 2
    wrow = torch.stack([fin.float(), torch.where(fin, fwd, 0.0)]).contiguous()
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)

    def k3(w):
        return estep.bwd_counts(*base, w, rows, offs, local=local)

    def p3(w):
        return estep.bwd_counts_reference(*base, w, rows, offs, local=local,
                                          max_prop=mp)

    part, sc = k3(wrow)
    tab = estep.estep_reduce(part)
    torch.cuda.synchronize()
    part_p, sc_p = p3(wrow)
    err_c = _compare_counts(torch.cat([part.ravel(), sc.ravel()]),
                            torch.cat([part_p.ravel(), sc_p.ravel()]))
    del part_p, sc_p
    err_r = _compare_counts(tab, estep.estep_reduce_reference(part))
    # each finite pair's back-start posterior exp(back - fwd) is 1 in exact
    # arithmetic (rtol 5e-3, tests/test_pallas_counts.py)
    bsp = sc[4][fin].double().cpu()
    check(bool(((bsp - 1).abs() < 5e-3).all()),
          f"{name}: back-start posterior off 1 by {float((bsp - 1).abs().max()):.3g}")
    # the whole E-step again: the tables must repeat bit for bit
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
    k2(variants[0])  # warm
    t = {"fwd_store": (_time(k2, variants[1:]), _time(p2, variants[1:1 + n_plain])),
         "bwd_counts": (_time(k3, wv), _time(p3, wv[:n_plain]))}
    t_red = _time(estep.estep_reduce, [part] * n_runs)
    t_lib = _time(lambda p: torch.sum(p, dim=0), [part] * n_runs)

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
    out = {}
    for k, err in (("fwd_store", err_f), ("bwd_counts", err_c)):
        ms, plain = t[k][0] * 1e3, t[k][1] * 1e3
        out[k] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                  "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "library_ms": None}
    out["estep_reduce"] = {
        "max_abs_err": err_r, "ms": t_red * 1e3, "plain_ms": t_lib * 1e3,
        "bound_ms": bounds["estep_reduce"][0],
        "bound_by": bounds["estep_reduce"][1], "library_ms": t_lib * 1e3}
    log(f"phase 2b: {name}: B={B} W={W} Ly={Ly} "
        f"{'local' if local else 'global'}, {cells} in-envelope cells; "
        f"max abs err fwd {err_f:.3g}, counts {err_c:.3g}, reduce {err_r:.3g}; "
        f"back-start posterior within {float((bsp - 1).abs().max()):.3g} of 1; "
        f"tables bit-identical over two runs [{card}]")
    for k, v in out.items():
        lib = ("" if v["library_ms"] is None
               else f", torch.sum {v['library_ms']:.4f} ms")
        log(f"phase 2b: {name}: {k} {v['ms']:.3f} ms (median of {n_runs}), "
            f"plain {v['plain_ms']:.3f} ms (median of "
            f"{n_plain if k != 'estep_reduce' else n_runs}){lib}, bound "
            f"{v['bound_ms']:.4f} ms ({v['bound_by']}) [{card}]")
    return out


def phase2b_estep(card):
    import numpy as np
    import torch

    from quaff_tpu_torch import kernels
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


def _estep_launches():
    from quaff_tpu_torch.dp import estep

    return {k: getattr(estep, k).launches
            for k in ("fwd_store", "bwd_counts", "estep_reduce")}


def _reset_launches():
    from quaff_tpu_torch.dp import estep, fill_v2

    fill_v2.band_fill.launches = 0
    for k in ("fwd_store", "bwd_counts", "estep_reduce"):
        getattr(estep, k).launches = 0


def _loglikes(err):
    import re

    return [float(v) for v in re.findall(r"log-likelihood \(([^)]*)\)", err)]


def phase3b_train_goldens(card):
    from quaff_tpu_torch.logger import logger

    c8 = str(DATA / "c8f30.fastq.gz")
    before = _estep_launches()
    t0 = time.perf_counter()
    out, err = _cli(["train", c8, c8, "-kmatchmb", "10", "-fwdstrand",
                     "-maxiter", "2", "-v"], "cuda", stderr=True)
    logger.verbosity = 0
    dt = time.perf_counter() - t0
    n = {k: v - before[k] for k, v in _estep_launches().items()}
    check(min(n.values()) > 0, f"c8f30 train: a kernel was not launched {n}")
    lls = re.findall(r"log-likelihood \(([^)]*)\)", err)
    check(lls[:2] == ["-22808.4", "-17564.7"],
          f"c8f30 train: log-likelihoods {lls}, want -22808.4, -17564.7")
    want = json.loads((DATA / "c8f30-train2.oracle.json").read_text())
    bad = _json_close(json.loads(out), want, 2e-3, 1e-4, skip=("/refBase",))
    check(not bad, f"c8f30 train vs c8f30-train2.oracle.json: {bad[:5]}")
    log(f"phase 3b: train c8f30 (2 EM iterations): log-likelihoods "
        f"{lls[0]}, {lls[1]} and params within 1e-4 + 2e-3*|want| of "
        f"c8f30-train2.oracle.json; launches {n}; {dt:.2f} s [{card}]")

    args = [str(DATA / "synth12-genome.fasta"), str(DATA / "synth12.fastq"),
            "-kmatchn", "10", "-fwdstrand"]
    before = _estep_launches()
    fast = json.loads(_cli(["count", *args, "-fast"], "cuda"))
    n = {k: v - before[k] for k, v in _estep_launches().items()}
    check(min(n.values()) > 0, f"count -fast: a kernel was not launched {n}")
    parity = json.loads(_cli(["count", *args], "cuda"))
    bad = _json_close(fast, parity, 5e-3, 5e-3)
    check(not bad, f"count -fast vs count: {bad[:5]}")
    log(f"phase 3b: count -fast synth12 within 5e-3 + 5e-3*|count| of the "
        f"float64 parity count; launches {n} [{card}]")


# ---------------------------------------------------------------- phase 5


def phase5_train(card, n_reads=256, genome_len=200_000, n_check=16):
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


        chunks, biggest = [], {}
        spent = {}  # host seconds per step of the path, device fenced
        orig_multi = estep.estep_fused_multi

        def recording(v2tab, batch, gid, null_lls, local=True, max_prop=None):
            B = int(batch["member"].shape[0])
            chunks.append(B)
            if B > biggest.get("B", 0):
                biggest.update(B=B, batch=batch, v2=v2tab, local=local)
            return orig_multi(v2tab, batch, gid, null_lls, local, max_prop)

        def timing(owner, name, key, static=False):
            """Times each call of owner.name; returns what restores it."""
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

        estep.estep_fused_multi = recording
        patched = [
            timing(trainer.QuaffCounter, "get_counts", "E-step"),
            timing(trainer.QuaffCounter, "_envelopes", "envelopes"),
            timing(engine.PairBatch, "build_packed", "batch layout",
                   static=True),
            timing(trainer, "to_device", "host-to-device"),
            timing(estep, "estep_fused_multi", "fused E-step on the card"),
            timing(QuaffParamCounts, "fit", "M-step"),
        ]
        try:
            torch.cuda.reset_peak_memory_stats()
            _reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                out, err = _cli(["train", str(gpath), str(rpath), "-maxiter",
                                 "2", "-threads", threads, "-v"], "cuda",
                                stderr=True)
                wall = time.perf_counter() - t0
            launches = _estep_launches()
        finally:
            for owner, name, fn in reversed(patched):
                setattr(owner, name, fn)
            estep.estep_fused_multi = orig_multi
        estep_s = spent["E-step"]
        device = {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            if t > 0:
                device[e.key] = t / 1e6
        busy = sum(device.values())
        top = sorted(device.items(), key=lambda kv: -kv[1])[:6]
        from quaff_tpu_torch.logger import logger

        logger.verbosity = 0
        check(min(launches.values()) > 0,
              f"the train path missed a kernel: {launches}")
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
            f"{lls[0]:.6g} -> {lls[1]:.6g}; {sum(chunks)} pair fills in "
            f"chunks of {chunks}; launches {launches}; peak device memory "
            f"{peak:.2f} GiB [{card}]")
        log("phase 5: where the time goes (host seconds, fenced by "
            "synchronize; summed over both iterations): "
            + "; ".join(f"{k} {sum(v):.3f} s in {len(v)} calls"
                        for k, v in spent.items()))
        log(f"phase 5: torch.profiler: device busy {busy:.3f} s of "
            f"{wall:.3f} s wall ({100 * busy / wall:.2f}%); top: "
            + "; ".join(f"{k[:60]} {v * 1e3:.1f} ms" for k, v in top)
            + f" [{card}]")

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
    phase3_goldens()
    phase3b_train_goldens(card)
    k1_launches = phase4_workload(card)
    launches, chunk = phase5_train(card)
    # K2, K3 and the reduction at the shape of the train path's largest
    # chunk, against their plain versions (timed once: minutes otherwise)
    estep_k = estep_case(f"phase-5 chunk", chunk["batch"], chunk["v2"],
                         chunk["local"], card, n_plain=1)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    kernels = [dict(name="band_fill", route="cuda",
                    source="quaff_tpu_torch/csrc/band_fill.cu",
                    replaces="quaff_tpu/dp/pallas_v2.py:491",
                    launches=k1_launches, library_ms=None,
                    **{k: k1[k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")})]
    replaces = {"fwd_store": "quaff_tpu/dp/pallas_counts.py:507",
                "bwd_counts": "quaff_tpu/dp/pallas_counts.py:561",
                "estep_reduce": "quaff_tpu/dp/pallas_counts.py:561"}
    for name, rep_at in replaces.items():
        kernels.append(dict(name=name, route="cuda",
                            source="quaff_tpu_torch/csrc/estep.cu",
                            replaces=rep_at, launches=launches[name],
                            **estep_k[name]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
