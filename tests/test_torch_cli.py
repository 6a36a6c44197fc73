"""The port's command line (python -m quaff_tpu_torch.cli): a full align run
never imports JAX, CUDA asked for on a host without a card fails loudly,
-mesh in one process is a world of one rank with the local output, and
what has no meaning is refused, never silently ignored."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from quaff_tpu_torch.cli import main

REPO = pathlib.Path(__file__).resolve().parent.parent


def _run(argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_align_runs_without_jax(data_dir):
    """A whole align in a fresh interpreter (pytest's own process has JAX
    loaded by conftest.py): output is the golden and neither jax nor the
    CUDA kernel loader is imported."""
    code = (
        "import sys\n"
        "from quaff_tpu_torch.cli import main\n"
        f"rc = main(['align', {str(data_dir / 'synth12-genome.fasta')!r}, "
        f"{str(data_dir / 'synth12.fastq')!r}, '-kmatchn', '10', "
        "'-nothreshold'])\n"
        "sys.stdout.flush()\n"
        "loaded = sorted(m for m in ('jax', 'jaxlib', 'quaff_tpu.dp', "
        "'quaff_tpu.aligner', 'quaff_tpu_torch.kernels', 'triton') "
        "if m in sys.modules)\n"
        "sys.stderr.write('LOADED=' + ','.join(loaded) + '\\n')\n"
        "sys.exit(rc)\n"
    )
    env = dict(os.environ, QUAFF_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "LOADED=\n" in res.stderr
    assert res.stdout == (data_dir / "synth12-align.oracle.stk").read_text()


def test_cuda_without_a_card_exits_nonzero(data_dir, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cuda")
    rc, out, err = _run(["align", str(data_dir / "tiny.fasta"),
                         str(data_dir / "tiny.fastq")])
    assert rc != 0
    assert out == ""
    assert "QUAFF_TORCH_DEVICE=cuda" in err and "torch.cuda.is_available()" in err


@pytest.mark.parametrize("command", ["train", "count", "overlap"])
def test_unported_commands(command, data_dir, monkeypatch):
    """train, count and overlap take -mesh: in one process a world of one
    rank, whose output is the local run's (count without -fast ignores
    it, as the JAX package's does)."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    args = [command, str(data_dir / "tiny.fasta"), str(data_dir / "tiny.fastq")]
    if command == "overlap":
        args = [command, str(data_dir / "synth12.fastq"), "-kmatchn", "10"]
    rc, want, err = _run(args)
    assert rc == 0, err
    rc, out, err = _run(args + ["-mesh"])
    assert rc == 0, err
    assert out == want


@pytest.mark.parametrize(
    "flags", [("-mesh",), ("-coordinator", "localhost:1234")])
def test_unported_align_options(flags, data_dir, monkeypatch):
    """align -mesh in one process gives the local text; -coordinator
    without -nprocs is refused before any work."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    args = ["align", str(data_dir / "tiny.fasta"), str(data_dir / "tiny.fastq"),
            "-nothreshold"]
    rc, out, err = _run(args + list(flags))
    if flags[0] == "-mesh":
        assert rc == 0, err
        assert out == _run(args)[1]
    else:
        assert rc == 1
        assert "need -nprocs" in err
        assert out == ""


def test_server_refuses_mesh(data_dir, monkeypatch):
    """A worker serves its jobs on its one device: -mesh is the client's."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    rc, out, err = _run(["server", "align", str(data_dir / "tiny.fasta"),
                         str(data_dir / "tiny.fastq"), "-mesh"])
    assert rc == 1
    assert "-mesh" in err and "not of a worker" in err
    assert out == ""


def test_profile_writes_a_trace(data_dir, tmp_path, monkeypatch):
    """-profile <dir>: a torch.profiler Chrome trace of the whole command
    (CPU activity on a host without a card); the output is unchanged."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    args = ["align", str(data_dir / "tiny.fasta"), str(data_dir / "tiny.fastq"),
            "-nothreshold"]
    rc, want, _ = _run(args)
    rc2, out, err = _run(args + ["-profile", str(tmp_path / "trace")])
    assert rc == rc2 == 0, err
    assert out == want
    (trace,) = (tmp_path / "trace").glob("quaff-align-*.trace.json")
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("band_fill" in n or "aten::" in n for n in names)


@pytest.mark.parametrize("flags", [("-mesh",)])
def test_unported_overlap_options(flags, data_dir, monkeypatch):
    """overlap -mesh in one process gives the local text."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    args = ["overlap", str(data_dir / "synth12.fastq"), "-kmatchn", "10",
            "-nothreshold"]
    rc, out, err = _run(args + list(flags))
    assert rc == 0, err
    assert out == (data_dir / "synth12-overlap.oracle.stk").read_text()


def test_overlap_runs(data_dir, monkeypatch):
    """`overlap` is a command of the port: the synth12 golden on the CPU."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    rc, out, err = _run(["overlap", str(data_dir / "synth12.fastq"),
                         "-kmatchn", "10", "-nothreshold"])
    assert rc == 0, err
    assert out == (data_dir / "synth12-overlap.oracle.stk").read_text()


def test_savenull_and_null(data_dir, tmp_path, monkeypatch):
    """-savenull writes the fitted null model; -null reads it back and the
    alignment is unchanged."""
    from quaff_tpu.io.fastseq import read_fast_seqs
    from quaff_tpu.model.params import QuaffNullParams

    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    null_file = tmp_path / "null.json"
    args = ["align", str(data_dir / "tiny.fasta"), str(data_dir / "tiny.fastq"),
            "-nothreshold"]
    rc, first, _ = _run(args + ["-savenull", str(null_file)])
    assert rc == 0 and first.count("#=GF Score") == 1
    want = io.StringIO()
    QuaffNullParams.fit(read_fast_seqs(str(data_dir / "tiny.fastq"))).write_json(want)
    assert json.loads(null_file.read_text()) == json.loads(want.getvalue())
    rc, second, _ = _run(args + ["-null", str(null_file)])
    assert rc == 0 and second == first


def test_help_and_version():
    rc, out, _ = _run(["help"])
    assert rc == 0 and "align" in out and "overlap reads.fastq" in out
    rc, out, _ = _run(["version"])
    assert rc == 0 and out.startswith("quaff-tpu-torch")
