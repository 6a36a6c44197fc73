"""`quaff overlap` in the PyTorch port (quaff_tpu_torch/overlap.py and the
CLI) on the CPU, where K4 runs as its plain version: byte for byte against
the JAX package's align_all, the per-pair float64 route, `-log dpmatrix`
and the overlap goldens.  The text is decided by the float64 exact pass,
so the tolerance is none: K4 only chooses which pairs and strips reach it.
"""

import contextlib
import io

import numpy as np
import pytest

from quaff_tpu.aligner import DPConfig as JaxDPConfig
from quaff_tpu.cli import main as jax_main
from quaff_tpu.formats.alignment import AlignmentPrinter as JaxPrinter
from quaff_tpu.io.fastseq import FastSeq as JaxFastSeq
from quaff_tpu.io.fastseq import add_revcomps as jax_add_revcomps
from quaff_tpu.logger import logger as jax_logger
from quaff_tpu.model.params import QuaffNullParams as JaxNull
from quaff_tpu.overlap import QuaffOverlapAligner as JaxAligner
from quaff_tpu_torch import overlap as ov
from quaff_tpu_torch.aligner import VITERBI_CELL_SIZE, DPConfig
from quaff_tpu_torch.cli import main
from quaff_tpu_torch.dp import ov_fill
from quaff_tpu_torch.formats.alignment import AlignmentPrinter
from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex, add_revcomps
from quaff_tpu_torch.logger import logger
from quaff_tpu_torch.model.params import QuaffNullParams, default_params
from test_torch_overlap import _params_pair


@pytest.fixture
def k4_calls(monkeypatch):
    """Counts the calls of K4's plain version (the CPU route of ov_fill;
    launches are counted on a card only)."""
    calls = []
    orig = ov_fill.ov_fill_reference

    def spy(*a, **k):
        calls.append(a[2].shape)
        return orig(*a, **k)

    monkeypatch.setattr(ov_fill, "ov_fill_reference", spy)
    return calls


def _repeat_reads():
    """Four 250-350 bp reads from one 600 bp genome, 5% substitutions (the
    set of tests/test_pallas_overlap.py's pipeline test), as (JAX, port)
    FastSeq lists."""
    rng = np.random.default_rng(5)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 600))
    recs = []
    for i in range(4):
        s0 = int(rng.integers(0, 200))
        ln = int(rng.integers(250, 350))
        s = list(base[s0 : s0 + ln])
        for p in range(len(s)):
            if rng.random() < 0.05:
                s[p] = "acgt"[int(rng.integers(0, 4))]
        qual = "".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(s)))
        recs.append((f"r{i}", "".join(s), qual))
    return ([JaxFastSeq(name=n, seq=s, qual=q) for n, s, q in recs],
            [FastSeq(name=n, seq=s, qual=q) for n, s, q in recs])


@pytest.mark.parametrize("threshold", ["nothreshold", "default", "-2500"])
@pytest.mark.parametrize("gap_order", [0, 1])
def test_align_all_matches_jax(gap_order, threshold, k4_calls):
    """At -inf every pair is reported; at the default threshold (0) K4
    prunes every pair of this set (their scores are -1800 to -3400); at
    -2500 it prunes some and keeps the rest."""
    jp, qp = _params_pair(gap_order)
    jreads, reads = _repeat_reads()
    jprinter, printer = JaxPrinter(), AlignmentPrinter()
    if threshold != "default":
        value = float("-inf") if threshold == "nothreshold" else float(threshold)
        jprinter.log_odds_threshold = printer.log_odds_threshold = value
    want = io.StringIO()
    JaxAligner(jp, JaxNull.fit(jreads), JaxDPConfig()).align_all(
        want, jax_add_revcomps(jreads), len(jreads), jprinter)
    n = want.getvalue().count("# STOCKHOLM")
    assert (n == 0) == (threshold == "default")
    if threshold == "-2500":
        assert 0 < n < 18  # 18 pairs reported at -inf
    got = io.StringIO()
    ov.QuaffOverlapAligner(qp, QuaffNullParams.fit(reads),
                           DPConfig(device="cpu")).align_all(
        got, add_revcomps(reads), len(reads), printer)
    assert got.getvalue() == want.getvalue()
    # the batched route scored pairs through K4 (at -inf threshold the
    # single-strip pairs skip it, the multi-strip ones do not)
    assert k4_calls


def test_sequential_route_matches_batched():
    """The port's two routes give the same text: the sequential float64
    route (one fill with matrices per pair, no kernel pruning) and the
    batched route through K4's plain version and the exact pass.  The
    threshold keeps some pairs, so the sequential route's float64 score
    prepass prunes too."""
    _, reads = _repeat_reads()
    seqs = add_revcomps(reads)
    aligner = ov.QuaffOverlapAligner(default_params(), QuaffNullParams.fit(reads),
                                     DPConfig(device="cpu"))
    pairs = list(aligner.enumerate_pairs(seqs, len(reads)))
    printer = AlignmentPrinter()
    printer.log_odds_threshold = -2500.0
    batched, sequential = io.StringIO(), io.StringIO()
    aligner._align_all_batched(batched, seqs, pairs, printer)
    aligner._align_all_sequential(sequential, seqs, pairs, printer)
    assert batched.getvalue() == sequential.getvalue()
    assert 0 < sequential.getvalue().count("#=GF Score") < len(pairs)


def _format(a):
    s = io.StringIO()
    a.write_stockholm(s)
    return s.getvalue()


def test_exact_pass_matches_per_pair():
    """The exact pass (the winning strip of each pair, filled and walked by
    one checkpointed native call) is byte for byte the per-pair
    bounding-band fill + traceback, with and without strip pruning by
    per-strip scores (tests/test_overlap_golden.py)."""
    from quaff_tpu_torch.native import overlap_strip_score_native

    rng = np.random.default_rng(7)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 2000))
    reads = []
    for i in range(4):
        ln = int(rng.integers(400, 600))
        s0 = int(rng.integers(0, 1200))
        seq = list(base[s0 : s0 + ln])
        for _ in range(len(seq) // 20):
            seq[int(rng.integers(0, len(seq)))] = "acgt"[int(rng.integers(0, 4))]
        reads.append(FastSeq(name=f"r{i}", seq="".join(seq), qual="".join(
            chr(33 + int(q)) for q in rng.integers(3, 40, ln))))
    cfg = DPConfig(device="cpu")
    aligner = ov.QuaffOverlapAligner(default_params(), QuaffNullParams.fit(reads),
                                     cfg)
    jobs = []
    for nx, ny, y_comp in aligner.enumerate_pairs(reads, len(reads)):
        env = cfg.make_envelope(reads[nx], KmerIndex(reads[ny], cfg.kmer_len),
                                VITERBI_CELL_SIZE)
        jobs.append((nx, ny, y_comp, env))
    assert any(len(env.strips()) > 1 for *_, env in jobs)
    want = [aligner.overlap_pair(reads[nx], reads[ny], yc)
            for nx, ny, yc, _ in jobs]

    # per-strip raw end scores from float64 strip fills, as K4 reports them
    seg_scores = {}
    for (nx, ny, yc, env), (_, strips) in zip(jobs, aligner._strip_jobs(reads, jobs)):
        t = aligner._tables(yc)
        x, y = reads[nx], reads[ny]
        y_tok, y_mk, y_ik, y_q = ov._y_strand_arrays(y, t)
        sm = np.full(ov_fill.MAX_SEGS, -np.inf)
        for k, (s, off, rows) in enumerate(strips):
            sm[k] = overlap_strip_score_native(
                x.kmers(t.match_kmer_len),
                np.concatenate([[0], x.kmers(t.indel_kmer_len)]),
                x.qual_scores(), len(x.seq), True,
                y_mk, np.concatenate([[0], y_ik]), y_q, len(y.seq), True,
                off, rows, s.band_lo, s.band_width, s.member_mask(), t)
        seg_scores[(nx, ny)] = sm
    assert any(np.sum(np.isfinite(sm) & (sm < np.max(sm) - 1.0)) > 0
               for sm in seg_scores.values()), "no prunable strip"
    for scores in (None, seg_scores):
        work = aligner._path_worker(reads, {}, {},
                                    aligner._strip_jobs(reads, jobs, scores))
        got = work(work.items)
        for (nx, ny, _, _), a in zip(jobs, want):
            b = got[(nx, ny)] and aligner._render_path(reads, got[(nx, ny)])
            if a is None or b is None:
                assert a is None and b is None
                continue
            assert a.score == b.score
            assert _format(a) == _format(b)


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def test_dpmatrix_dump_matches_jax(tmp_path, monkeypatch):
    """`-log dpmatrix` takes the sequential route and dumps every cell of
    each pair's band, byte-identical to the JAX package's dump."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    _, reads = _repeat_reads()
    path = tmp_path / "reads.fastq"
    path.write_text("".join(f"@{r.name}\n{r.seq[:120]}\n+\n{r.qual[:120]}\n"
                            for r in reads[:3]))
    argv = ["overlap", str(path), "-fwdstrand", "-nothreshold", "-log",
            "dpmatrix"]
    saved = (set(logger.tags), set(jax_logger.tags))
    try:
        want = _run(jax_main, argv)
        got = _run(main, argv)
    finally:
        logger.tags, jax_logger.tags = saved
    assert want[0] == 0 and got[0] == 0
    assert got[1] == want[1] and got[1].count("#=GF")
    assert got[2] == want[2] and "result" in got[2]


GOLDENS = {
    "synth12": (["synth12.fastq", "-kmatchn", "10", "-nothreshold"],
                "synth12-overlap.oracle.stk", True),
    "synth12-gap1": (["synth12.fastq", "-params", "params-gaporder1.json",
                      "-kmatchn", "10", "-nothreshold"],
                     "synth12-overlap-gap1.oracle.stk", True),
    "c8f30-revcomp": (["c8f30.fastq.gz", "copy-of-c8f30.fastq", "-kmatchmb",
                       "10"], "c8f30-overlap-revcomp.oracle.txt", True),
    "c8f30-noqual": (["c8f30.fastq.gz", "copy-of-c8f30.fastq", "-kmatchmb",
                      "10", "-fwdstrand", "-noquals"],
                     "c8f30-overlap-noqual.oracle.txt", False),
    "c8f30-self": (["c8f30.fastq.gz", "copy-of-c8f30.fastq", "-kmatchmb",
                    "10", "-fwdstrand"], "c8f30-self-overlap.json", False),
}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_overlap_cli_goldens(name, data_dir, monkeypatch, k4_calls):
    """The CLI on QUAFF_TORCH_DEVICE=cpu, byte for byte against the
    reference binary's overlap goldens; runs of several pairs reach K4
    (a single pair takes the sequential route)."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    args, golden, through_k4 = GOLDENS[name]
    argv = ["overlap"] + [str(data_dir / a) if (data_dir / a).exists() else a
                          for a in args]
    rc, out, err = _run(main, argv)
    assert rc == 0, err
    assert out == (data_dir / golden).read_text()
    assert bool(k4_calls) == through_k4


def test_lane_cap_rebands_wide_pairs(monkeypatch):
    """A pair wider than the lane cap is re-banded by fit_envelope_lanes;
    one still too wide skips K4 and goes straight to the exact pass.  The
    text stays the JAX package's (whose CPU route has no cap)."""
    refits = []
    fit = ov.fit_envelope_lanes
    monkeypatch.setattr(ov, "OV_LANE_CAP", 40)
    monkeypatch.setattr(ov, "fit_envelope_lanes",
                        lambda *a, **k: refits.append(a[2]) or fit(*a, **k))
    jp, qp = _params_pair(0)
    jreads, reads = _repeat_reads()
    want = io.StringIO()
    JaxAligner(jp, JaxNull.fit(jreads), JaxDPConfig()).align_all(
        want, jax_add_revcomps(jreads), len(jreads), JaxPrinter())
    got = io.StringIO()
    ov.QuaffOverlapAligner(qp, QuaffNullParams.fit(reads),
                           DPConfig(device="cpu")).align_all(
        got, add_revcomps(reads), len(reads), AlignmentPrinter())
    assert refits and set(refits) == {40}
    assert got.getvalue() == want.getvalue()
