"""A tiny cell for the CPU tests: a 300-base genome, read sets of three
reads of its 100-base amplicon, the port on the CPU (its exact float64
engine), and limits for that engine (set from its readings here, ~1e-11, with room;
the written parameters' six digits read up to ~2e-4, as on the cells)."""

from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from hb import harness  # noqa: E402

LIMITS = {"ll_gap_nats": 1e-7, "counts_gap": 1e-7, "order_diffs": 0,
          "mstep_gap": 1e-3, "nb_shape_gap": 1e-2}


def make_bench(tmp: pathlib.Path) -> pathlib.Path:
    """A benchmark folder with the tiny cell `tiny.train`, beside the real
    one's data, traffic and metrics; returns its BENCHMARK.json."""
    for sub in ("data", "traffic", "metrics"):
        shutil.copytree(BENCH / sub, tmp / sub)
    (tmp / "configs").mkdir()
    cfg = json.loads((BENCH / "configs" / "lambda-ctl.json").read_text())
    cfg.update(name="tiny", limits=dict(LIMITS),
               amplicon={"trim5": 180, "trim3": 20})
    cfg["references"]["length"] = 300
    (tmp / "configs" / "tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "train-full.json").read_text())
    traffic.update(reads_per_set=3, sets=2)
    (tmp / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [dict(spec["configs"][0], name="tiny",
                            file="configs/tiny.json")]
    spec["workloads"] = [dict(spec["workloads"][0], name="tiny.train",
                              config="tiny", traffic="tiny")]
    for m in spec["per_layer"]:
        m["workloads"] = ["tiny.train"]
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(spec))
    return path


def run_tiny(bench_json: pathlib.Path, capsys, *extra, seed=3000000011,
             seconds=10):
    """Run the tiny cell on the CPU, one intra-op thread (the tests run in
    several workers); (exit code, result dict or None)."""
    import torch

    torch.set_num_threads(1)
    rc = harness.run(["--workload", "tiny.train", "--seed", str(seed),
                      "--seconds", str(seconds), *extra], time.time(),
                     bench_json=bench_json, bench_dir=bench_json.parent,
                     device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if out else None)
