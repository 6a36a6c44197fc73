"""A configuration, a traffic mix and a per-layer metric added as new files
are found by their names, with no file that exists edited."""

import json

from hmmbench_tiny import BENCH, ROOT

from hb import harness


def test_added_files_are_found_by_name(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:  # the cells already there, where they are
        c["file"] = str(ROOT / c["file"])
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    cfg = json.loads((BENCH / "configs" / "lambda-ctl.json").read_text())
    cfg["name"] = "bac-150k"
    cfg["references"]["length"] = 150000
    (tmp_path / "configs" / "bac-150k.json").write_text(json.dumps(cfg))
    traffic = {"command": ["train", "{refs}", "{reads}", "-kmatchoff"],
               "reads_per_set": 4, "sets": 2,
               "reads": {"kind": "amplicon"}}
    (tmp_path / "traffic" / "train-short.json").write_text(
        json.dumps(traffic))
    (tmp_path / "metrics" / "fits_per_window.py").write_text(
        "def read(ctx):\n    return ctx.fits or None\n")
    spec["configs"].append({"name": "bac-150k", "source": "x",
                            "file": "configs/bac-150k.json", "reduced": [],
                            "why": "x"})
    spec["workloads"].append({"name": "bac-150k.train-short",
                              "config": "bac-150k", "traffic": "train-short",
                              "chips": 1, "why": "x"})
    spec["per_layer"].append({"name": "fits_per_window", "unit": "fits",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "train_kb_per_s",
                              "workloads": ["bac-150k.train-short"]})
    bench_json = tmp_path / "BENCHMARK.json"
    bench_json.write_text(json.dumps(spec))

    cell, c, t, per_layer = harness.load_cell(bench_json,
                                              "bac-150k.train-short",
                                              bench_dir=tmp_path)
    assert cell["chips"] == 1
    assert c["references"]["length"] == 150000
    assert t["reads_per_set"] == 4
    assert [m["name"] for m in per_layer] == ["fits_per_window"]
    read = harness.load_metric(tmp_path, "fits_per_window")
    assert read(type("Ctx", (), {"fits": 3})) == 3
    # the cells already there keep their metrics
    _, _, _, old = harness.load_cell(bench_json, "lambda-ctl.train-full",
                                     bench_dir=BENCH)
    assert "fits_per_window" not in [m["name"] for m in old]
    assert len(old) == 6
