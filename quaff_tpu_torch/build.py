"""Build a shared library from the checkout's sources at first use.

The port compiles its own native code on the machine that runs it: the
CUDA kernels (csrc/*.cu, nvcc) and the host library (native/*.cpp, g++).
Each source is compiled to an object by its own compiler process, all
started together, and the objects are linked into one library under
build/quaff_tpu_torch/ in the checkout (listed in .gitignore).  The
library's file name carries a hash of its sources and flags, so a changed
source builds anew and an unchanged one is reused.  A file lock makes
concurrent processes (test workers) build once and share the result.
A failed compile or link raises with the compiler's output.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Iterable, List, Optional

ROOT = pathlib.Path(__file__).resolve().parent.parent
BUILD_DIR = ROOT / "build" / "quaff_tpu_torch"


def source_hash(files: Iterable[pathlib.Path], *extra: str) -> str:
    """A short hash of the files' names and bytes plus `extra` strings."""
    h = hashlib.sha256()
    for s in extra:
        h.update(s.encode())
    for f in sorted(files):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_library(out: pathlib.Path, sources: List[pathlib.Path],
                  compiler: str, compile_flags: List[str],
                  link_flags: List[str]) -> Optional[str]:
    """Make `out` from `sources` unless it exists.  Returns the compilers'
    output when this call built it, None when it was there already."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{out.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return None
        work = BUILD_DIR / f".{out.stem}.{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        try:
            objs, procs = [], []
            for src in sources:
                obj = work / (src.stem + ".o")
                cmd = [compiler, *compile_flags, "-c", str(src), "-o", str(obj)]
                procs.append((cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
                objs.append(str(obj))
            log = []
            failed = []
            for cmd, p in procs:
                text, _ = p.communicate()
                log.append(text)
                if p.returncode != 0:
                    failed.append(f"{' '.join(cmd)}\n(exit {p.returncode})\n"
                                  f"{text}")
            if failed:
                raise RuntimeError(f"{compiler} failed:\n" + "\n".join(failed))
            tmp = work / out.name
            cmd = [compiler, "-o", str(tmp), *objs, *link_flags]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log.append(res.stdout + res.stderr)
            if res.returncode != 0:
                raise RuntimeError(
                    f"link failed (exit {res.returncode}):\n{' '.join(cmd)}\n"
                    f"{res.stdout}{res.stderr}"
                )
            os.replace(tmp, out)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return "".join(log)
