"""The port's command line (python -m quaff_tpu_torch.cli): a full align run
never imports JAX, CUDA asked for on a host without a card fails loudly,
and what is not ported yet is refused, never silently ignored."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from quaff_tpu_torch.cli import NOT_PORTED, main

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


@pytest.mark.parametrize("command", ["train", "count", "overlap", "server"])
def test_unported_commands(command, data_dir, monkeypatch):
    """server is refused; train, count and overlap are ported, and refuse
    the distributed backends they do not have yet (-mesh here)."""
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    extra = ["-mesh"] if command != "server" else []
    rc, out, err = _run([command, str(data_dir / "tiny.fasta"),
                         str(data_dir / "tiny.fastq"), *extra])
    assert rc == 1
    assert NOT_PORTED in err
    assert out == ""


@pytest.mark.parametrize(
    "flags",
    [("-mesh",), ("-remote", "localhost:8000"), ("-remote", "me@host"),
     ("-qsubjobs", "2"), ("-ec2instances", "1"),
     ("-coordinator", "localhost:1234"), ("-profile", "trace")],
)
def test_unported_align_options(flags, data_dir, monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    rc, out, err = _run(["align", str(data_dir / "tiny.fasta"),
                         str(data_dir / "tiny.fastq"), *flags])
    assert rc == 1
    assert NOT_PORTED in err
    assert out == ""


@pytest.mark.parametrize(
    "flags", [("-mesh",), ("-remote", "localhost:8000"), ("-qsubjobs", "2")])
def test_unported_overlap_options(flags, data_dir, monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")
    rc, out, err = _run(["overlap", str(data_dir / "tiny.fastq"), *flags])
    assert rc == 1
    assert NOT_PORTED in err
    assert out == ""


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
