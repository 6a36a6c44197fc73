#!/usr/bin/env python3
"""Bring-up check of the PyTorch port (quaff_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; one CUDA card

It builds everything from the checkout and runs five phases; any failure
exits non-zero before the final line is printed.

  0  the card's name and power limit (nvidia-smi), torch and CUDA versions
  1  build K1 (quaff_tpu_torch/csrc/*.cu with nvcc, sm_90a) and
     libquaffio.so (the float64 refill); report the refill route
  2  K1 against its plain PyTorch version on the card: c8f30 against itself
     lane-packed at B=2048 (the align configuration), plus forward, global,
     no-quality, gap-order-1 and a band wider than shared memory; median
     times of both, in-envelope cells/s
  3  the port's `align` CLI on cuda, byte for byte against four goldens,
     with K1 launched in each run
  4  the main path at a size users run: a seeded 200 kb genome and 1024
     reads of 2-10 kb (12% substitutions and indels, half reverse strand,
     with qualities) aligned through the CLI on cuda; reads/s and K1
     launches; the first 32 reads again on the CPU (plain version) must
     give the same text

The next-to-last line is {"kernels": [...]} and the last line
{"ok": true, "device": {...}}.  Nothing of JAX is imported.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
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
    from quaff_tpu import native
    from quaff_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.library()
    t_k1 = time.perf_counter() - t0
    how = "built" if kernels.build_log is not None else "reused"
    log(f"phase 1: K1 library {how} in {t_k1:.1f} s "
        f"({kernels.library_path().relative_to(ROOT)})")
    for line in (kernels.build_log or "").splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    ok = native.build_native(quiet=True)
    t_nat = time.perf_counter() - t0
    route = ("native libquaffio.so (fill + walk)"
             if native.align_path_available()
             else "float64 torch engine on the host (libquaffio.so missing)")
    log(f"phase 1: libquaffio.so build {'ok' if ok else 'FAILED'} in "
        f"{t_nat:.1f} s; winner refill route: {route}")


# ---------------------------------------------------------------- phase 2


def _synthetic_pairs(rng, n, with_qual=True):
    """Reads matching two copies of a repeat in their ref: multi-strip
    envelopes (the lane-packed layout with halo seams)."""
    from quaff_tpu.envelope import sparse_envelope
    from quaff_tpu.io.fastseq import FastSeq, KmerIndex

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
    """Median seconds of fn(v) over distinct inputs, fenced by synchronize."""
    import torch

    times = []
    for v in variants:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(v)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


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
    log(f"phase 2: {name}: B={B} W={W} Ly={inp['keys'].shape[1]} {mode} "
        f"{'local' if local else 'global'}: max abs err {err:.3g}; "
        f"K1 {ms:.3f} ms, plain {plain_ms:.3f} ms (median of {n_runs}) "
        f"[{card}]")
    return err, ms, plain_ms


def phase2_kernel(card):
    import numpy as np
    import torch

    from quaff_tpu.envelope import full_envelope, make_envelope
    from quaff_tpu.io.fastseq import FastSeq, KmerIndex, read_fast_seqs
    from quaff_tpu.model.params import QuaffParams, default_params
    from quaff_tpu_torch import kernels
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
    err, ms, plain_ms = run_case("c8f30 packed", pb, tables, "viterbi", True,
                                 card)
    cells = env.num_cells * B
    log(f"phase 2: c8f30 packed: {cells} in-envelope cells: K1 "
        f"{cells / (ms / 1e3):.4g} cells/s, plain {cells / (plain_ms / 1e3):.4g}"
        f" cells/s [{card}]")
    main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}

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


def _cli(argv, device):
    """The port's CLI in-process on `device`; returns its stdout."""
    from quaff_tpu_torch.cli import main

    saved = os.environ.get("QUAFF_TORCH_DEVICE")
    os.environ["QUAFF_TORCH_DEVICE"] = device
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
    finally:
        if saved is None:
            del os.environ["QUAFF_TORCH_DEVICE"]
        else:
            os.environ["QUAFF_TORCH_DEVICE"] = saved
    check(rc == 0, f"align {' '.join(argv[1:])} exited {rc}")
    return out.getvalue()


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
              min_len=2000, max_len=10_000, err=0.12):
    """A genome and noisy reads from a fixed seed: each position of a read
    is substituted, followed by an inserted base, or deleted with
    probabilities 0.6*err, 0.2*err and 0.2*err; half the reads are reverse
    complemented; qualities are drawn from the quality values of the
    repository's nanopore read (c8f30), which the default model fits."""
    import numpy as np

    from quaff_tpu.io.fastseq import read_fast_seqs

    rng = np.random.default_rng(seed)
    quals = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0].qual_scores()
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genome = rng.integers(0, 4, genome_len).astype(np.int8)
    gpath = tmp / "genome.fasta"
    gpath.write_text(">genome\n" + acgt[genome].tobytes().decode() + "\n")
    recs = []
    for i in range(n_reads):
        n = int(rng.integers(min_len, max_len + 1))
        s0 = int(rng.integers(0, genome_len - n))
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
    head = tmp / "reads32.fastq"
    head.write_text("".join(recs[:32]))
    return gpath, rpath, head


def phase4_workload(card, n_reads=1024, genome_len=200_000, n_check=32):
    from quaff_tpu.io.fastseq import read_fast_seqs
    from quaff_tpu.model.params import QuaffNullParams
    from quaff_tpu_torch.dp import fill_v2

    threads = str(os.cpu_count() or 1)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        t0 = time.perf_counter()
        gpath, rpath, head = _workload(tmp, n_reads=n_reads,
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
    phase3_goldens()
    launches = phase4_workload(card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [{
        "name": "band_fill",
        "route": "cuda",
        "source": "quaff_tpu_torch/csrc/band_fill.cu",
        "replaces": "quaff_tpu/dp/pallas_v2.py:491",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
