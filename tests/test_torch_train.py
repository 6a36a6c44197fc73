"""`train` through the PyTorch port on the CPU, against the reference
goldens.

On the CPU the counter takes the exact engine in float64, as the JAX
package does off the TPU.  The fused E-step (K2 + K3 through their plain
versions) is forced here by routing reads to it as a card would, and held
against the goldens too.
"""

import contextlib
import io
import json

import numpy as np
import pytest

from quaff_tpu_torch import trainer
from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.cli import main
from quaff_tpu_torch.io.fastseq import read_fast_seqs
from quaff_tpu_torch.model.params import QuaffNullParams, QuaffParamCounts


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")


def _run(argv, cli=main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def _mismatches(mine, want, rtol, atol, skip=None):
    """Numbers of two JSON documents further apart than atol + rtol*|want|
    (lists included), except under the path `skip`."""
    bad = []

    def walk(a, b, path):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (u, v) in enumerate(zip(a, b)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(a, (int, float)) and not (skip and path.startswith(skip)):
            if not abs(float(a) - float(b)) <= atol + rtol * abs(float(b)):
                bad.append((path, a, b))

    walk(mine, want, "")
    return bad


def _route_to_kernel(monkeypatch):
    """Reads with qualities take the fused E-step, as on a card."""
    monkeypatch.setattr(trainer.QuaffCounter, "_use_kernel",
                        lambda self, y: y.has_qual())


@pytest.mark.parametrize("route", ["engine", "kernel"])
def test_train_two_iterations_matches_reference(data_dir, route, monkeypatch):
    """tests/test_train_golden.py through the port: the reference's EM
    trajectory (log-likelihoods -22808.4, -17564.7) and its fitted
    parameters, by the exact engine and by K2 + K3 (whose scaled float32
    fills keep the log-likelihood to the printed digits)."""
    if route == "kernel":
        _route_to_kernel(monkeypatch)
    reads = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    refs = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    for r in refs:
        r.qual = ""
    null = QuaffNullParams.fit(reads)
    prior = QuaffParamCounts.zero(1, 0)
    prior.init_counts(9, 9, 5, 1, null)
    logs = []
    qp = trainer.QuaffTrainer(max_iterations=2).fit(
        refs, reads, prior.fit(), null, prior,
        DPConfig(kmer_threshold=-1, max_size=10 << 20), log=logs.append)
    assert "log-likelihood (-22808.4)" in logs[0]
    assert "log-likelihood (-17564.7)" in logs[1]
    out = io.StringIO()
    qp.write_json(out)
    want = json.loads((data_dir / "c8f30-train2.oracle.json").read_text())
    # refBase excluded: the reference's fitRefSeqs reads an uninitialised
    # total (tests/test_train_golden.py)
    assert _mismatches(json.loads(out.getvalue()), want, 2e-3, 1e-4,
                       skip="/refBase") == []
    np.testing.assert_allclose(np.sum(qp.ref_base), 1.0, atol=1e-12)


def test_multiref_train_with_pruning(data_dir, tmp_path):
    """tests/test_multiref.py's Delta=20 ref pruning run through the port."""
    params_file = tmp_path / "params.json"
    rc, out = _run(["train", str(data_dir / "multiref.fasta"),
                    str(data_dir / "c8f30.fastq.gz"), "-kmatchmb", "10",
                    "-fwdstrand", "-maxiter", "2", "-saveparams",
                    str(params_file)])
    assert rc == 0 and out == ""
    mine = json.loads(params_file.read_text())
    want = json.loads((data_dir / "multiref-train2.oracle.json").read_text())
    assert _mismatches(mine, want, 2e-3, 1e-4, skip="/refBase") == []


def test_train_checkpoint_resumes(data_dir, tmp_path):
    """-checkpoint: a run stopped after one EM iteration resumes at the
    second and ends where an uninterrupted run ends."""
    args = ["train", str(data_dir / "synth12-genome.fasta"),
            str(data_dir / "synth12.fastq"), "-kmatchn", "10", "-fwdstrand"]
    rc, full = _run(args + ["-maxiter", "2"])
    assert rc == 0
    ckpt = str(tmp_path / "ckpt")
    rc, _ = _run(args + ["-maxiter", "1", "-checkpoint", ckpt])
    assert rc == 0
    rc, resumed = _run(args + ["-maxiter", "2", "-checkpoint", ckpt])
    assert rc == 0
    assert resumed == full

