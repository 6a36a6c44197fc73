"""Nothing a run loads has the top-level name jax, jaxlib, flax or
quaff_tpu (whole names: quaff_tpu_torch is the port), and the plain
reference imports nothing of the port."""

import ast
import json
import subprocess
import sys

from hmmbench_tiny import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "quaff_tpu"}
REFERENCE = ("hb/pairhmm.py", "hb/quaffmodel.py")


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_nothing_forbidden():
    files = [BENCH / "run.py", *BENCH.glob("hb/*.py"),
             *BENCH.glob("metrics/*.py")]
    assert len(files) > 8
    for f in files:
        assert not _imports(f) & FORBIDDEN, f
    # the whole-name rule: the port's name begins with the JAX package's
    assert "quaff_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    for rel in REFERENCE:
        names = _imports(BENCH / rel)
        assert not {n for n in names if n.startswith("quaff")}, rel
        assert names <= {"__future__", "json", "math", "numpy", "torch"}, rel


def test_a_run_loads_nothing_forbidden(tmp_path):
    code = f"""
import json, sys, time, pathlib
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH / 'tests')!r}]
from hmmbench_tiny import make_bench
from hb import harness
bench = make_bench(pathlib.Path({str(tmp_path)!r}))
rc = harness.run(["--workload", "tiny.train", "--seed", "5", "--seconds",
                  "1"], time.time(), bench_json=bench,
                 bench_dir=bench.parent, device="cpu")
print(json.dumps({{"rc": rc, "modules": sorted({{m.split(".")[0]
                                               for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600,
                         env={"OMP_NUM_THREADS": "1", "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["rc"] == 0
    assert "quaff_tpu_torch" in last["modules"]
    assert not set(last["modules"]) & FORBIDDEN
