"""The port's qsub/NFS batch backend on the CPU (the mirror of
tests/test_qsub.py, the qsub half of tests/test_failure_injection.py and
tests/test_cli_flags.py's -qsubheader/-qsubopts case).

Substituting /bin/sh for qsub makes submission a synchronous local run of
the generated job script (the reference's zero-cluster trick,
Makefile:172-176): each job is a fresh `python -m quaff_tpu_torch.cli
server ... -readindex ... -job info.json` process, so this also covers the
single-shot server path and single-read loading end to end.
"""

import contextlib
import io
import json

import pytest

from quaff_tpu_torch.batch import MAX_QSUB_ATTEMPTS, QsubConfig, QsubRunner
from quaff_tpu_torch.cli import main


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    # job processes inherit the device, and one intra-op thread (the suite
    # runs many processes at once)
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _run(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def test_qsub_align_golden(data_dir, tmp_path):
    rc, out = _run(["align", str(data_dir / "c8f30.fastq.gz"),
                    str(data_dir / "c8f30.fastq.gz"), "-kmatchmb", "10",
                    "-fwdstrand", "-qsubjobs", "1", "-qsubpath", "/bin/sh",
                    "-qsubdir", str(tmp_path)])
    assert rc == 0
    assert out == (data_dir / "c8f30-self-align.json").read_text()
    # the job's files are on the "shared filesystem"
    job_dir = tmp_path / "job1"
    for name in ("job.sh", "info.json", "done", "result"):
        assert (job_dir / name).exists()
    script = (job_dir / "job.sh").read_text()
    assert "-m quaff_tpu_torch.cli server align" in script
    assert "-readindex" in script and "quaff_tpu.cli" not in script
    assert json.loads((job_dir / "info.json").read_text()) == {
        "yName": out.split("#=GS CC Read ")[1].split("\n")[0]}


def test_qsub_count_matches_plain_count(data_dir, tmp_path):
    """`count -qsubjobs`: a `server count` job loads its read without
    qualities (as the JAX package's does, quaff_tpu/server.py:293-296), so
    the merged counts are the plain float64 count of the reads without
    qualities, through 6-significant-figure JSON: within 1e-6 + 1e-5*|x|
    (tests/test_server.py:103)."""
    from test_torch_server import _close

    from quaff_tpu_torch.aligner import DPConfig
    from quaff_tpu_torch.io.fastseq import read_fast_seqs
    from quaff_tpu_torch.model.params import QuaffNullParams, default_params
    from quaff_tpu_torch.trainer import QuaffCounter

    d = str(data_dir / "c8f30.fastq.gz")
    rc, out = _run(["count", d, d, "-kmatchmb", "10", "-fwdstrand",
                    "-qsubjobs", "1", "-qsubpath", "/bin/sh",
                    "-qsubdir", str(tmp_path)])
    assert rc == 0
    assert "server count" in (tmp_path / "job1" / "job.sh").read_text()
    refs, reads = read_fast_seqs(d), read_fast_seqs(d)
    null = QuaffNullParams.fit(reads)  # the client's, sent with each job
    for s in refs + reads:
        s.qual = ""
    want, _, _ = QuaffCounter(
        default_params(), null,
        DPConfig(kmer_threshold=-1, max_size=10 << 20, device="cpu"),
    ).get_counts(refs, reads)
    buf = io.StringIO()
    want.write_json(buf)
    assert _close(json.loads(out), json.loads(buf.getvalue()))


def test_qsub_header_and_opts(data_dir, tmp_path):
    """-qsubheader prepends the header file to job.sh and -qsubopts rides
    the submission command line (makeQsubScript, qmodel.cpp:1030-1039)."""
    header = tmp_path / "header.sh"
    header.write_text("#!/bin/sh\n# PBS -l walltime=1:00:00\n")
    base = ["align", str(data_dir / "tiny.fasta"),
            str(data_dir / "tiny.fastq"), "-nothreshold"]
    rc0, out0 = _run(base)
    rc, out = _run(base + ["-qsubjobs", "1", "-qsubpath", "/bin/sh",
                           "-qsubopts", "-e", "-qsubdir", str(tmp_path / "jobs"),
                           "-qsubheader", str(header)])
    assert rc == rc0 == 0 and out == out0 and out.count("#=GF Score") == 1
    script = (tmp_path / "jobs" / "job1" / "job.sh").read_text()
    assert script.startswith("#!/bin/sh\n# PBS -l walltime=1:00:00\n")


def test_qsub_submit_retries_then_succeeds(tmp_path):
    """A qsub that fails twice then behaves like /bin/sh: the runner retries
    (at most 3 attempts, qmodel.h:81) and returns the result."""
    marker = tmp_path / "attempts"
    flaky = tmp_path / "flaky-qsub"
    flaky.write_text(
        "#!/bin/sh\n"
        f"n=$(cat {marker} 2>/dev/null || echo 0)\n"
        f"echo $((n+1)) > {marker}\n"
        "[ $n -ge 2 ] || exit 1\n"
        'exec /bin/sh "$@"\n'
    )
    flaky.chmod(0o755)
    job_out = tmp_path / "ran"
    runner = QsubRunner(QsubConfig(
        qsub_path=str(flaky), temp_dir=str(tmp_path / "jobs"),
        worker_command=f"touch {job_out}; echo", server_args="align"))
    # the job's command line, echoed into its result file
    info = tmp_path / "jobs" / "job3" / "info.json"
    assert runner.run_task("{}", timeout=30) == f"server align -job {info}\n"
    assert job_out.exists()
    assert int(marker.read_text().strip()) == 3  # failed twice, ran third


def test_qsub_submit_gives_up_after_three(tmp_path):
    marker = tmp_path / "attempts"
    dead = tmp_path / "dead-qsub"
    dead.write_text(
        "#!/bin/sh\n"
        f"n=$(cat {marker} 2>/dev/null || echo 0)\n"
        f"echo $((n+1)) > {marker}\n"
        "exit 1\n"
    )
    dead.chmod(0o755)
    runner = QsubRunner(QsubConfig(
        qsub_path=str(dead), temp_dir=str(tmp_path / "jobs"),
        worker_command="true", server_args=""))
    with pytest.raises(RuntimeError, match="3 attempts"):
        runner.run_task("{}", timeout=30)
    assert int(marker.read_text().strip()) == MAX_QSUB_ATTEMPTS
