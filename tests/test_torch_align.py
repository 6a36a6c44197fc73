"""`quaff align` through the PyTorch port, end to end on the CPU: every pair
is scored by K1's plain PyTorch version (QUAFF_TORCH_DEVICE=cpu) and the
winners are refilled in float64.  The text must be byte-identical to the
reference binary's goldens and to the JAX QuaffAligner.
"""

import contextlib
import io

import numpy as np
import pytest

from quaff_tpu_torch.aligner import DPConfig, QuaffAligner
from quaff_tpu_torch.cli import main
from quaff_tpu_torch.formats.alignment import AlignmentPrinter, OutputFormat
from quaff_tpu_torch.io.fastseq import FastSeq, read_fast_seqs
from quaff_tpu_torch.model.params import QuaffNullParams, default_params


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def c8f30(data_dir):
    reads = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    refs = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    for r in refs:
        r.qual = ""  # refs are loaded without quality scores
    return refs, reads, QuaffNullParams.fit(reads)


@pytest.mark.parametrize("fmt", [OutputFormat.STOCKHOLM, OutputFormat.SAM])
def test_c8f30_self_align(c8f30, data_dir, fmt):
    """tests/test_align_golden.py's flagship: Stockholm byte for byte, and
    its SAM checks."""
    refs, reads, null = c8f30
    aligner = QuaffAligner(
        default_params(), null, DPConfig(kmer_threshold=-1, max_size=10 << 20)
    )
    out = io.StringIO()
    aligner.align_all(out, refs, reads, AlignmentPrinter(format=fmt))
    if fmt == OutputFormat.STOCKHOLM:
        assert out.getvalue() == (data_dir / "c8f30-self-align.json").read_text()
        return
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("@HD\tVN:1.0\tGO:query")
    assert lines[1].startswith("@SQ\tSN:channel_8_read_24")
    assert lines[1].endswith("LN:6604")
    body = lines[2].split("\t")
    assert body[1] == "0" and body[3] == "1"
    assert body[-1] == "AS:i:7982"


@pytest.mark.parametrize(
    "files,extra,golden",
    [
        (("synth12-genome.fasta", "synth12.fastq"),
         ("-kmatchn", "10", "-nothreshold"), "synth12-align.oracle.stk"),
        (("synth12-genome.fasta", "synth12.fastq"),
         ("-kmatchn", "10", "-nothreshold", "-format", "sam"),
         "synth12-align.oracle.sam"),
        (("multiref.fasta", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand"), "multiref-align.oracle.txt"),
        (("multiref.fasta", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-printall"),
         "multiref-printall.oracle.txt"),
        (("multiref.fasta", "multireads.fastq"),
         ("-kmatchmb", "10", "-fwdstrand"), "multireads-align.oracle.txt"),
        (("revref.fasta", "c8f30.fastq.gz"), ("-kmatchmb", "10"),
         "revref-align.oracle.txt"),
        (("revref.fasta", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-format", "sam"), "revref-sam.oracle.txt"),
        (("synth12-genome.fasta", "synth12.fastq"),
         ("-kmatchn", "10", "-nothreshold", "-params",
          "params-gaporder1.json"), "synth12-align-gap1.oracle.stk"),
        (("synth12-genome.fasta", "synth12.fastq"),
         ("-kmatchn", "10", "-nothreshold", "-params",
          "synth12-train-order2.oracle.json"), "synth12-align-order2.oracle.stk"),
        (("synth12-genome.fasta", "synth12.fastq"),
         ("-kmatchn", "10", "-nothreshold", "-params",
          "synth12-train-order3.oracle.json"), "synth12-align-order3.oracle.stk"),
        (("c8f30.fastq.gz", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-global"),
         "c8f30-global-align.oracle.txt"),
        (("c8f30.fastq.gz", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-noquals"),
         "c8f30-noquals-align.oracle.txt"),
        (("c8f30.fastq.gz", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-format", "fasta"),
         "c8f30-fasta-align.oracle.txt"),
        (("c8f30.fastq.gz", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-format", "refseq"),
         "c8f30-refseq-align.oracle.txt"),
        (("c8f30.fastq.gz", "c8f30.fastq.gz"),
         ("-kmatchmb", "10", "-fwdstrand", "-nothreshold", "-params",
          "c8f30-params-sub2.oracle.json"), "c8f30-align-sub2.oracle.txt"),
    ],
    ids=["synth12-stk", "synth12-sam", "multiref", "multiref-printall",
         "multireads", "revref", "revref-sam", "synth12-gap1",
         "synth12-order2", "synth12-order3", "c8f30-global", "c8f30-noquals",
         "c8f30-fasta", "c8f30-refseq", "c8f30-order3"],
)
def test_cli_align_goldens(data_dir, files, extra, golden):
    extra = [str(data_dir / a) if a.endswith(".json") else a for a in extra]
    rc, out = _run(["align", *(str(data_dir / f) for f in files), *extra])
    assert rc == 0
    assert out == (data_dir / golden).read_text()


def test_dpmatrix_log_dump(data_dir, capsys):
    """`-log dpmatrix` dumps the winner's float64 band to stderr, byte for
    byte as the reference does."""
    from quaff_tpu_torch.logger import logger

    rc, out = _run([
        "align", str(data_dir / "dpm_ref.fasta"), str(data_dir / "dpm_read.fastq"),
        "-kmatchoff", "-fwdstrand", "-nocolor", "-log", "dpmatrix",
    ])
    err = capsys.readouterr().err
    logger.tags.discard("dpmatrix")
    assert rc == 0
    assert out == (data_dir / "dpm-align.oracle.txt").read_text()
    assert err == (data_dir / "dpm-align-dpmatrix.oracle.txt").read_text()


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """The winners' float64 refill has one route, the port's libquaffio: a
    build that fails raises with the compiler's output, and no caller gets
    a missing library to route around."""
    from quaff_tpu_torch import native

    for name in native.SOURCES:
        (tmp_path / name).write_text("#error quaff broken source\n")
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="quaff broken source"):
        native.get_lib()
    assert not native.library_path().exists()


def _repeat_region_inputs(FastSeq=FastSeq):
    """tests/test_multiread.py's repeated-region reads: envelopes split
    into strips, the degraded second copy is dropped by the near-best
    strip filter for some reads, two refs compete.  FastSeq: the class of
    the side that gets them."""
    rng = np.random.default_rng(11)
    core = "".join("acgt"[t] for t in rng.integers(0, 4, 120))
    spacer = "".join("acgt"[t] for t in rng.integers(0, 4, 200))
    core2 = list(core)
    for p in range(0, len(core2), 17):
        core2[p] = "acgt"[(("acgt".index(core2[p])) + 1) % 4]
    ref1 = FastSeq(name="refA", seq=core + spacer + "".join(core2))
    ref2 = FastSeq(
        name="refB", seq="".join("acgt"[t] for t in rng.integers(0, 4, 500))
    )
    reads = []
    for i in range(5):
        ys = list(core)
        for p in range(len(ys)):
            if rng.random() < 0.05:
                ys[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(FastSeq(
            name=f"r{i}", seq="".join(ys),
            qual="".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(ys))),
        ))
    return [ref1, ref2], reads


@pytest.mark.parametrize("print_all", [False, True])
def test_matches_jax_aligner_on_repeats(print_all):
    from quaff_tpu import formats as jax_formats
    from quaff_tpu import model as jax_model
    from quaff_tpu.aligner import DPConfig as JaxDPConfig
    from quaff_tpu.aligner import QuaffAligner as JaxQuaffAligner
    from quaff_tpu.io.fastseq import FastSeq as JaxFastSeq

    jrefs, jreads = _repeat_region_inputs(JaxFastSeq)
    jprinter = jax_formats.alignment.AlignmentPrinter()
    jprinter.log_odds_threshold = float("-inf")
    ref = io.StringIO()
    JaxQuaffAligner(
        jax_model.default_params(), jax_model.QuaffNullParams.fit(jreads),
        JaxDPConfig(kmer_threshold=5, threads=2), print_all=print_all,
    ).align_all(ref, jrefs, jreads, jprinter)

    refs, reads = _repeat_region_inputs()
    null = QuaffNullParams.fit(reads)
    printer = AlignmentPrinter()
    printer.log_odds_threshold = float("-inf")
    port = QuaffAligner(
        default_params(), null, DPConfig(kmer_threshold=5, threads=2),
        print_all=print_all,
    )
    got = io.StringIO()
    port.align_all(got, refs, reads, printer)
    assert got.getvalue() == ref.getvalue()
    # the batched pipeline and the one-read path agree too
    seq = io.StringIO()
    printer.write_header(seq, refs, group_by_query=True)
    for y in reads:
        for a in port.align_read(refs, y):
            printer.write_alignment(seq, a)
    assert seq.getvalue() == got.getvalue()


def test_lane_cap_guard_keeps_alignments(monkeypatch):
    """A pair whose packed band exceeds the lane cap is re-banded with the
    memory-fitted walk; the winning path lies in the true seed cluster, so
    the text equals the JAX aligner's, which scores the unfitted band."""
    from quaff_tpu import formats as jax_formats
    from quaff_tpu import model as jax_model
    from quaff_tpu.aligner import DPConfig as JaxDPConfig
    from quaff_tpu.aligner import QuaffAligner as JaxQuaffAligner
    from quaff_tpu.io.fastseq import FastSeq as JaxFastSeq
    import quaff_tpu_torch.aligner as amod
    from test_long_band import _scattered_workload

    jref, jread = _scattered_workload(np.random.default_rng(11))
    jreads = [jread, JaxFastSeq(name="read2", seq=jread.seq[40:],
                                qual=jread.qual[40:])]
    jprinter = jax_formats.alignment.AlignmentPrinter()
    jprinter.log_odds_threshold = float("-inf")
    want = io.StringIO()
    JaxQuaffAligner(jax_model.default_params(),
                    jax_model.QuaffNullParams.fit(jreads),
                    JaxDPConfig(kmer_threshold=10)
                    ).align_all(want, [jref], jreads, jprinter)

    ref = FastSeq(name=jref.name, seq=jref.seq, qual=jref.qual)
    reads = [FastSeq(name=y.name, seq=y.seq, qual=y.qual) for y in jreads]
    null = QuaffNullParams.fit(reads)
    printer = AlignmentPrinter()
    printer.log_odds_threshold = float("-inf")

    refits = []
    fit = amod.fit_envelope_lanes
    monkeypatch.setattr(amod, "ALIGN_LANE_CAP", 250)
    monkeypatch.setattr(amod, "fit_envelope_lanes",
                        lambda *a, **k: refits.append(a[2]) or fit(*a, **k))
    got = io.StringIO()
    QuaffAligner(default_params(), null, DPConfig(kmer_threshold=10)
                 ).align_all(got, [ref], reads, printer)
    assert refits == [250, 250]
    assert got.getvalue() == want.getvalue()
