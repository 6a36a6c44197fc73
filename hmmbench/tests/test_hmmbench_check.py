"""The check that decides `correct`, on a tiny cell on the CPU: a sound run
passes; the control (the plain reference one precision down in the
E-step's place) and each fault a training cell can have fail."""

import json
import time

import pytest
import torch

from hmmbench_tiny import BENCH, LIMITS, make_bench, run_tiny

from hb import faults, harness
from quaff_tpu_torch import trainer
from quaff_tpu_torch.model import params


@pytest.fixture
def bench(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return make_bench(tmp_path)


def test_sound_run_is_correct(bench, capsys):
    rc, res = run_tiny(bench, capsys)
    assert rc == 0
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["metrics"]["train_kb_per_s"]["value"] > 0


def test_control_is_not_correct(bench, capsys):
    rc, res = run_tiny(bench, capsys, "--control")
    assert rc == 0
    assert not res["correct"]
    assert res["checks"]["ll_gap_nats"]["value"] > \
        res["checks"]["ll_gap_nats"]["limit"]


def _unchanged_mstep(monkeypatch):
    start = params.QuaffParams.from_json(
        (BENCH / "data" / "defaultparams.json").read_text())
    monkeypatch.setattr(params.QuaffParamCounts, "fit", faults.unchanged_step(
        start)(params.QuaffParamCounts.fit))


def _estep_fault(name):
    def plant(monkeypatch):
        monkeypatch.setattr(trainer.QuaffCounter, "count_reads",
                            faults.ESTEP[name](
                                trainer.QuaffCounter.count_reads))
    return plant


@pytest.mark.parametrize("fault, number", [
    (_unchanged_mstep, "mstep_gap"),
    (_estep_fault("half_batch"), "counts_gap"),
    (_estep_fault("altered_answer"), "ll_gap_nats"),
    (_estep_fault("altered_count"), "counts_gap"),
])
def test_fault_is_not_correct(bench, capsys, monkeypatch, fault, number):
    fault(monkeypatch)
    rc, res = run_tiny(bench, capsys)
    assert rc == 0 and res["attempted"] >= 1
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_readings_of_the_control_and_a_fault(bench, capsys):
    """--readings prints the check's numbers for each seed; the control's
    and a planted fault's read over the limits that sound runs keep."""
    torch.set_num_threads(1)
    got = {}
    for extra in ((), ("--control",), ("--fault", "half_batch")):
        rc = harness.run(["--workload", "tiny.train", "--seed", "3000000019",
                          "--seconds", "1", "--readings", "2", *extra],
                         time.time(), bench_json=bench,
                         bench_dir=bench.parent, device="cpu")
        assert rc == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert [x["seed"] for x in lines] == [3000000019,
                                              3000000019 + 1_000_003]
        got[extra] = [x["readings"] for x in lines]
    for r in got[()]:
        assert all(r[k] <= LIMITS[k] for k in LIMITS)
    for r in got[("--control",)]:
        assert r["ll_gap_nats"] > LIMITS["ll_gap_nats"]
    for r in got[("--fault", "half_batch")]:
        assert r["counts_gap"] > LIMITS["counts_gap"]
