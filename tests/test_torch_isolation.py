"""The port stands alone: no file of quaff_tpu_torch/ (nor chip_smoke.py)
imports the JAX package, and a port run loads neither the JAX package nor
JAX, nor the JAX package's prebuilt host library."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "quaff_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _jax_package_imports(path):
    """(line, module) of every import of quaff_tpu or its submodules."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name == "quaff_tpu" or name.startswith("quaff_tpu."):
                found.append((node.lineno, name))
    return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_package_import(path):
    assert _jax_package_imports(path) == []


def test_the_check_sees_an_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom quaff_tpu.io import fastseq\n"
                 "def g():\n    import quaff_tpu.native as n\n"
                 "from quaff_tpu_torch import cli\nfrom . import x\n")
    assert _jax_package_imports(f) == [(2, "quaff_tpu.io"),
                                       (4, "quaff_tpu.native")]


def test_port_runs_load_no_jax(data_dir):
    """Every port module imported (but __main__), then `align`,
    `count -fast` and `overlap` on the CPU, in a fresh interpreter: no jax,
    no quaff_tpu module, and no library loaded from the JAX package's
    directory."""
    code = f"""
import importlib, pathlib, sys
root = pathlib.Path({str(REPO)!r})
for f in sorted((root / "quaff_tpu_torch").rglob("*.py")):
    if f.name == "__main__.py":
        continue  # runs the CLI
    mod = ".".join(f.relative_to(root).with_suffix("").parts)
    importlib.import_module(mod.removesuffix(".__init__"))
from quaff_tpu_torch.cli import main
d = {str(data_dir)!r}
rc = main(["align", d + "/synth12-genome.fasta", d + "/synth12.fastq",
           "-kmatchn", "10", "-nothreshold"])
rc |= main(["count", d + "/synth12-genome.fasta", d + "/synth12.fastq",
            "-kmatchn", "10", "-fwdstrand", "-fast"])
rc |= main(["overlap", d + "/synth12.fastq", "-kmatchn", "10",
            "-nothreshold"])
sys.stdout.flush()
loaded = sorted(m for m in sys.modules
                if m in ("jax", "jaxlib", "quaff_tpu")
                or m.startswith(("jax.", "jaxlib.", "quaff_tpu.")))
maps = open("/proc/self/maps").read()
libs = [line for line in maps.splitlines()
        if str(root / "quaff_tpu") + "/" in line]
sys.stderr.write("LOADED=" + ",".join(loaded) + "\\n")
sys.stderr.write("LIBS=" + ",".join(libs) + "\\n")
sys.exit(rc)
"""
    env = dict(os.environ, QUAFF_TORCH_DEVICE="cpu")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "LOADED=\n" in res.stderr
    assert "LIBS=\n" in res.stderr
    align = (data_dir / "synth12-align.oracle.stk").read_text()
    overlap = (data_dir / "synth12-overlap.oracle.stk").read_text()
    assert res.stdout.startswith(align)
    assert res.stdout.endswith(overlap)
    assert '"insert"' in res.stdout[len(align):-len(overlap)]
