"""Queueing-system (qsub/PBS/SGE) batch backend over a shared filesystem.

Ported from quaff_tpu/batch.py, which reimplements the reference's qsub
path (src/qmodel.cpp:1030-1043, 2335-2448): each task gets a directory
jobNNN/ holding job.sh (header + a single-shot `server <mode> ... -job
info.json` run of the port's CLI appending to a result file, then touching
a done sentinel) and info.json (the task JSON); submission runs
`<qsub_path> <opts> <script>`; completion is detected by polling the
shared filesystem for the done sentinel with randomised delays.
Substituting /bin/sh for qsub turns submission into a synchronous local
run, the reference's own zero-cluster test trick (doc/manual.tex).
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import tempfile
import time
from dataclasses import dataclass

from .server import count_task, merge_counts, model_json

QSUB_SCRIPT = "job.sh"
QSUB_INFO = "info.json"
QSUB_RESULT = "result"
QSUB_DONE = "done"
MAX_QSUB_ATTEMPTS = 3  # qmodel.h:81


@dataclass
class QsubConfig:
    jobs: int = 0
    qsub_path: str = "qsub"
    qsub_opts: str = ""
    header: str = "#!/bin/sh\n"
    temp_dir: str = ""
    worker_command: str = ""  # e.g. "python -m quaff_tpu_torch.cli"
    server_args: str = ""  # mode + serialized flags + file args


class QsubRunner:
    def __init__(self, config: QsubConfig):
        self.config = config
        if not config.temp_dir:
            self._tmp = tempfile.TemporaryDirectory(prefix="quaffjobs")
            self.base_dir = self._tmp.name
        else:
            self._tmp = None
            self.base_dir = config.temp_dir
            os.makedirs(self.base_dir, exist_ok=True)
        self._n = 0

    def _make_job_dir(self) -> str:
        self._n += 1
        path = os.path.join(self.base_dir, f"job{self._n}")
        os.makedirs(path, exist_ok=True)
        return path

    def make_script(self, job_dir: str, extra_args: str = "") -> str:
        """Equivalent of makeQsubScript (qmodel.cpp:1030-1039)."""
        cfg = self.config
        info = os.path.join(job_dir, QSUB_INFO)
        result = os.path.join(job_dir, QSUB_RESULT)
        done = os.path.join(job_dir, QSUB_DONE)
        script = (
            cfg.header
            + f"{cfg.worker_command} server {cfg.server_args}"
            + (f" {extra_args}" if extra_args else "")
            + f" -job {info}"
            + f" 1>>{result}\n"
            + f"touch {done}\n"
        )
        path = os.path.join(job_dir, QSUB_SCRIPT)
        with open(path, "w") as f:
            f.write(script)
        os.chmod(path, 0o755)
        return path

    def run_task(self, task_json: str, extra_args: str = "",
                 poll_min: float = 0.001, poll_max: float = 1.0,
                 timeout: float = 3600.0) -> str:
        """Submit one task and wait for its result (QuaffTask::qsubResult,
        qmodel.cpp:2341-2376)."""
        cfg = self.config
        last_err = None
        for _ in range(MAX_QSUB_ATTEMPTS):
            job_dir = self._make_job_dir()
            with open(os.path.join(job_dir, QSUB_INFO), "w") as f:
                f.write(task_json)
            script = self.make_script(job_dir, extra_args)
            cmd = [p for p in f"{cfg.qsub_path} {cfg.qsub_opts} {script}".split() if p]
            try:
                subprocess.run(cmd, check=True, capture_output=True)
            except subprocess.CalledProcessError as e:
                last_err = e
                continue
            done = os.path.join(job_dir, QSUB_DONE)
            deadline = time.time() + timeout
            while not os.path.exists(done):
                if time.time() > deadline:
                    last_err = TimeoutError(f"qsub job {job_dir} timed out")
                    break
                time.sleep(random.uniform(poll_min, poll_max))
            else:
                result = os.path.join(job_dir, QSUB_RESULT)
                if os.path.exists(result):
                    with open(result) as f:
                        return f.read()
                return ""
        raise RuntimeError(f"qsub submission failed after {MAX_QSUB_ATTEMPTS} attempts: {last_err}")


def make_read_index_opt(seq) -> str:
    """-readindex file offset for single-read job loading
    (makeReadIndexOpt, qmodel.cpp:1041-1043)."""
    return f"-readindex {seq.filename} {seq.filepos}"


def qsub_align_all(out, runner: QsubRunner, reads, refs, printer) -> None:
    printer.write_header(out, refs, group_by_query=True)
    for y in reads:
        task = json.dumps({"yName": y.name})
        out.write(runner.run_task(task, make_read_index_opt(y), poll_max=0.05))


def qsub_overlap_all(out, runner: QsubRunner, seqs, n_originals, printer,
                     enumerate_pairs) -> None:
    printer.write_header(out, seqs, group_by_query=False)
    for nx, ny, y_comp in enumerate_pairs(seqs, n_originals):
        task = json.dumps(
            {"xName": seqs[nx].name, "yName": seqs[ny].name,
             "yComplemented": 1 if y_comp else 0}
        )
        extra = f"{make_read_index_opt(seqs[nx])} {make_read_index_opt(seqs[ny])}"
        out.write(runner.run_task(task, extra, poll_max=0.05))


def qsub_get_counts(runner: QsubRunner, refs, reads, params, null_model,
                    sort_order=None):
    if sort_order is None:
        sort_order = [list(range(len(refs))) for _ in reads]
    pj, nj = model_json(params, null_model)
    replies = (
        json.loads(runner.run_task(count_task(y, sort_order[ny], pj, nj),
                                   make_read_index_opt(y), poll_max=0.05))
        for ny, y in enumerate(reads)
    )
    return merge_counts(replies, params.match_kmer_len, params.indel_kmer_len)
