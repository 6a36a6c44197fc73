"""`quaff server` and the remote client of the PyTorch port, on the CPU.

The port's mirror of tests/test_server.py and of the socket half of
tests/test_failure_injection.py: real worker servers on localhost ports,
every task delegated over TCP with the reference's "# EOF"-framed JSON,
and the merged output held to the single-process goldens.  The port is
also held against the JAX package on the same jobs: per-job replies,
a port client against a JAX server and the reverse, and `train -remote`.
"""

import contextlib
import gc
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time
from collections import deque

import pytest
import torch

from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.formats.alignment import AlignmentPrinter, OutputFormat
from quaff_tpu_torch.io.fastseq import KmerIndex, read_fast_seqs
from quaff_tpu_torch.model.params import QuaffNullParams, default_params
from quaff_tpu_torch.server import (
    READY,
    QuaffServer,
    RemoteWorker,
    _run_remote_workers,
    remote_align_all,
    remote_get_counts,
    remote_overlap_all,
    server_from_args,
)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start_server(server, port: int, n_ports: int = 1):
    """Serve in a thread (READY to a buffer, stdout stays clean) and wait
    until every port accepts connections."""
    ready = io.StringIO()
    t = threading.Thread(target=server.serve, args=(port, n_ports),
                         kwargs={"ready_out": ready}, daemon=True)
    t.start()
    for _ in range(400):
        if ready.getvalue():
            break
        time.sleep(0.025)
    assert ready.getvalue() == READY + "\n"
    for p in range(port, port + n_ports):
        socket.create_connection(("127.0.0.1", p), timeout=5).close()
    return t


def _c8f30(data_dir, reads_mod=read_fast_seqs):
    reads = reads_mod(str(data_dir / "c8f30.fastq.gz"))
    refs = reads_mod(str(data_dir / "c8f30.fastq.gz"))
    for r in refs:
        r.qual = ""
    return refs, reads


@pytest.fixture(scope="module")
def c8f30_setup():
    data = pathlib.Path(__file__).parent / "data"
    refs, reads = _c8f30(data)
    null = QuaffNullParams.fit(reads)
    cfg = DPConfig(kmer_threshold=-1, max_size=10 << 20, device="cpu")
    return data, refs, reads, default_params(), null, cfg


def _align_server(setup):
    data, refs, reads, params, null, cfg = setup
    return QuaffServer("align", cfg, refs, reads, len(reads),
                       printer=AlignmentPrinter(format=OutputFormat.STOCKHOLM),
                       params=params, null_model=null)


def _close(a, b, rtol=1e-5, atol=1e-6):
    """Every number of two JSON documents within atol + rtol*|b|."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_close(a[k], b[k], rtol, atol)
                                            for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_close(x, y, rtol, atol)
                                        for x, y in zip(a, b))
    if isinstance(a, str):
        return a == b
    return abs(float(a) - float(b)) <= atol + rtol * abs(float(b))


def test_align_loopback_matches_golden(c8f30_setup):
    data, refs, reads = c8f30_setup[:3]
    port = _free_port()
    server = _align_server(c8f30_setup)
    t = _start_server(server, port)
    worker = RemoteWorker("localhost", port)
    out = io.StringIO()
    remote_align_all(out, [worker], reads, refs, server.printer)
    worker.quit()
    t.join(timeout=5)
    assert not t.is_alive()
    assert out.getvalue() == (data / "c8f30-self-align.json").read_text()


def test_count_loopback_matches_golden(c8f30_setup):
    """Counts travel as 6-significant-figure JSON: held to the golden at
    1e-6 + 1e-5*|x| (tests/test_server.py:103)."""
    data, refs, reads, params, null, cfg = c8f30_setup
    port = _free_port()
    t = _start_server(QuaffServer("count", cfg, refs, reads, len(reads)), port)
    worker = RemoteWorker("localhost", port)
    counts, loglike, orders = remote_get_counts([worker], refs, reads, params,
                                                null)
    worker.quit()
    t.join(timeout=5)
    assert orders == [[0]]
    out = io.StringIO()
    counts.write_json(out)
    want = json.loads((data / "c8f30-self-counts.json").read_text())
    assert _close(json.loads(out.getvalue()), want)


def test_job_file_single_shot(c8f30_setup, tmp_path):
    """The qsub/-job path (qmodel.cpp:2043-2050): one task from a job
    file, result on stdout."""
    data, _, reads = c8f30_setup[:3]
    job = tmp_path / "info.json"
    job.write_text(json.dumps({"yName": reads[0].name}))
    out = io.StringIO()
    _align_server(c8f30_setup).run_job_file(str(job), out)
    assert out.getvalue() == (data / "c8f30-self-align.json").read_text()


def _overlap_setup(data_dir, reads_mod=read_fast_seqs):
    return (reads_mod(str(data_dir / "c8f30.fastq.gz"))
            + reads_mod(str(data_dir / "copy-of-c8f30.fastq")))


def test_overlap_loopback_matches_golden(data_dir):
    """Overlap worker protocol: {"xName","yName","yComplemented"} jobs."""
    from quaff_tpu_torch.overlap import QuaffOverlapAligner

    seqs = _overlap_setup(data_dir)
    cfg = DPConfig(kmer_threshold=-1, max_size=10 << 20, device="cpu")
    printer = AlignmentPrinter(format=OutputFormat.STOCKHOLM)
    server = QuaffServer("overlap", cfg, seqs, seqs, 2, printer=printer,
                         params=default_params(),
                         null_model=QuaffNullParams.fit(seqs))
    port = _free_port()
    t = _start_server(server, port)
    worker = RemoteWorker("localhost", port)
    out = io.StringIO()
    pairs = QuaffOverlapAligner.__new__(QuaffOverlapAligner).enumerate_pairs
    remote_overlap_all(out, [worker], seqs, 2, printer, pairs)
    worker.quit()
    t.join(timeout=5)
    assert out.getvalue() == (data_dir / "c8f30-self-overlap.json").read_text()


# ---------------------------------------------------------------- JAX parity


def _jax_setup(data_dir):
    from quaff_tpu.aligner import DPConfig as JDPConfig
    from quaff_tpu.io import read_fast_seqs as jread
    from quaff_tpu.model import QuaffNullParams as JNull
    from quaff_tpu.model import default_params as jdefault

    return jread, JNull, jdefault(), JDPConfig(kmer_threshold=-1,
                                               max_size=10 << 20)


def _jax_server(mode, data_dir):
    from quaff_tpu.aligner import DPConfig as JDPConfig
    from quaff_tpu.formats import AlignmentPrinter as JPrinter
    from quaff_tpu.formats import OutputFormat as JFormat
    from quaff_tpu.io.fastseq import add_revcomps as jrevcomps
    from quaff_tpu.server import QuaffServer as JServer

    jread, JNull, jparams, jcfg = _jax_setup(data_dir)
    printer = JPrinter(format=JFormat.STOCKHOLM)
    if mode in GENOME_READS:
        genome, fastq, kmatchn = GENOME_READS[mode]
        refs = jread(str(data_dir / genome))
        for r in refs:
            r.qual = ""
        reads = jread(str(data_dir / fastq))
        printer.log_odds_threshold = float("-inf")
        return JServer("align", JDPConfig(kmer_threshold=kmatchn),
                       jrevcomps(refs), reads, len(reads), printer=printer,
                       params=jparams, null_model=JNull.fit(reads))
    if mode == "overlap":
        seqs = _overlap_setup(data_dir, jread)
        return JServer("overlap", jcfg, seqs, seqs, 2, printer=printer,
                       params=jparams, null_model=JNull.fit(seqs))
    refs, reads = _c8f30(data_dir, jread)
    if mode == "count":
        return JServer("count", jcfg, refs, reads, len(reads))
    return JServer("align", jcfg, refs, reads, len(reads), printer=printer,
                   params=jparams, null_model=JNull.fit(reads))


def _port_server(mode, data_dir):
    cfg = DPConfig(kmer_threshold=-1, max_size=10 << 20, device="cpu")
    printer = AlignmentPrinter(format=OutputFormat.STOCKHOLM)
    if mode in GENOME_READS:
        from quaff_tpu_torch.io.fastseq import add_revcomps

        genome, fastq, kmatchn = GENOME_READS[mode]
        refs = read_fast_seqs(str(data_dir / genome))
        for r in refs:
            r.qual = ""
        reads = read_fast_seqs(str(data_dir / fastq))
        printer.log_odds_threshold = float("-inf")
        return QuaffServer("align",
                           DPConfig(kmer_threshold=kmatchn, device="cpu"),
                           add_revcomps(refs), reads, len(reads),
                           printer=printer, params=default_params(),
                           null_model=QuaffNullParams.fit(reads))
    if mode == "overlap":
        seqs = _overlap_setup(data_dir)
        return QuaffServer("overlap", cfg, seqs, seqs, 2, printer=printer,
                           params=default_params(),
                           null_model=QuaffNullParams.fit(seqs))
    refs, reads = _c8f30(data_dir)
    if mode == "count":
        return QuaffServer("count", cfg, refs, reads, len(reads))
    return QuaffServer("align", cfg, refs, reads, len(reads), printer=printer,
                       params=default_params(),
                       null_model=QuaffNullParams.fit(reads))


def _jobs(mode, data_dir):
    """The job JSON a client sends for every task of the c8f30 runs."""
    from quaff_tpu_torch.server import count_task, model_json

    if mode in GENOME_READS:
        reads = read_fast_seqs(str(data_dir / GENOME_READS[mode][1]))
        return [json.dumps({"yName": y.name}) for y in reads]
    refs, reads = _c8f30(data_dir)
    if mode == "align":
        return [json.dumps({"yName": y.name}) for y in reads]
    if mode == "overlap":
        from quaff_tpu_torch.overlap import QuaffOverlapAligner

        seqs = _overlap_setup(data_dir)
        pairs = QuaffOverlapAligner.__new__(QuaffOverlapAligner).enumerate_pairs
        return [json.dumps({"xName": seqs[x].name, "yName": seqs[y].name,
                            "yComplemented": int(c)})
                for x, y, c in pairs(seqs, 2)]
    pj, nj = model_json(default_params(), QuaffNullParams.fit(reads))
    return [count_task(y, [0], pj, nj) for y in reads]


# align modes with a genome and its reads: (genome, reads, -kmatchn)
GENOME_READS = {"align-synth12": ("synth12-genome.fasta", "synth12.fastq", 10),
                "align-repeat": ("repeat-genome.fasta", "repeat.fastq", 20)}


def _write_repeat(dirpath):
    """A 6 kb genome (seeded) whose 1600-2000 repeats at 5000-5400, and two
    noisy reads of 1600-2000's neighbourhood (one reverse strand): each
    read's envelope holds the repeat's distant seed cluster, so its
    bounding band is tens of times its strips' lanes."""
    import numpy as np

    rng = np.random.default_rng(7)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    g = rng.integers(0, 4, 6000).astype(np.int8)
    g[5000:5400] = g[1600:2000]

    def noisy(t, err=0.1):
        r = rng.random(len(t))
        t = t.copy()
        sub = r < 0.6 * err
        t[sub] = (t[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        return t[~((r >= 0.8 * err) & (r < err))]

    reads = [noisy(g[500:2000]), (3 - noisy(g[800:2000]))[::-1]]
    (dirpath / "repeat-genome.fasta").write_text(
        ">genome\n" + acgt[g].tobytes().decode() + "\n")
    (dirpath / "repeat.fastq").write_text("".join(
        f"@repeat{i}\n{acgt[y].tobytes().decode()}\n+\n"
        + "".join(chr(33 + int(q)) for q in rng.integers(5, 40, len(y)))
        + "\n" for i, y in enumerate(reads)))


@pytest.mark.parametrize("mode", ["align", "align-synth12", "align-repeat",
                                  "overlap", "count"])
def test_handle_job_matches_jax(mode, data_dir, tmp_path):
    """For the same job JSON the port's reply is byte-identical to the JAX
    package's for align and overlap (both align jobs run align_read); count
    replies carry the same xSort and every value within rtol 1e-9.
    align-repeat holds the whole-envelope refill where a read's envelope
    spans distant seed clusters."""
    if mode == "align-repeat":
        from quaff_tpu_torch.aligner import VITERBI_CELL_SIZE
        from quaff_tpu_torch.envelope import pack_strips

        _write_repeat(tmp_path)
        data_dir = tmp_path
        cfg = DPConfig(kmer_threshold=20, device="cpu")
        genome = read_fast_seqs(str(tmp_path / "repeat-genome.fasta"))[0]
        for y, x in zip(read_fast_seqs(str(tmp_path / "repeat.fastq")),
                        (genome, genome.revcomp())):
            env = cfg.make_envelope(x, KmerIndex(y, cfg.kmer_len),
                                    VITERBI_CELL_SIZE)
            strips = pack_strips(env)
            assert len(strips) >= 2
            assert env.band_width > 10 * sum(s.band_width for s in strips)
    port_server = _port_server(mode, data_dir)
    jax_server = _jax_server(mode, data_dir)
    jobs = _jobs(mode, data_dir)
    assert jobs
    for job in jobs:
        mine = port_server.handle_job(json.loads(job))
        want = jax_server.handle_job(json.loads(job))
        if mode == "count":
            mine, want = json.loads(mine), json.loads(want)
            assert mine["yName"] == want["yName"]
            assert mine["xSort"] == want["xSort"]
            assert _close(mine, want, rtol=1e-9, atol=0.0)
        else:
            assert mine == want
            assert mine or mode == "overlap"
    assert port_server.handle_job({"quit": 1}) is None


@pytest.mark.parametrize("client", ["port", "jax"])
def test_wire_between_packages(client, data_dir):
    """A port client against a JAX server, and a JAX client against a port
    server: both give the golden text."""
    import quaff_tpu.server as jserver
    import quaff_tpu_torch.server as pserver

    if client == "port":
        server, lib = _jax_server("align", data_dir), pserver
        printer, (refs, reads) = AlignmentPrinter(
            format=OutputFormat.STOCKHOLM), _c8f30(data_dir)
    else:
        from quaff_tpu.formats import AlignmentPrinter as JPrinter
        from quaff_tpu.formats import OutputFormat as JFormat

        server, lib = _port_server("align", data_dir), jserver
        jread = _jax_setup(data_dir)[0]
        printer, (refs, reads) = JPrinter(
            format=JFormat.STOCKHOLM), _c8f30(data_dir, jread)
    port = _free_port()
    t = _start_server(server, port)
    worker = lib.RemoteWorker("127.0.0.1", port)
    out = io.StringIO()
    lib.remote_align_all(out, [worker], reads, refs, printer)
    worker.quit()
    t.join(timeout=5)
    assert out.getvalue() == (data_dir / "c8f30-self-align.json").read_text()


def test_train_remote_matches_jax(data_dir, monkeypatch):
    """`train -remote` against a loopback count server: the port's and the
    JAX package's remote train (each against a server of its own package)
    give the same params at tests/test_torch_train.py's tolerance."""
    from quaff_tpu.cli import main as jmain
    from quaff_tpu_torch.cli import main as pmain

    from test_torch_train import _mismatches

    monkeypatch.setenv("QUAFF_TPU_PLATFORM", "cpu")
    monkeypatch.setenv("QUAFF_TPU_X64", "1")
    args = [str(data_dir / "c8f30.fastq.gz"), str(data_dir / "c8f30.fastq.gz"),
            "-kmatchmb", "10", "-fwdstrand", "-maxiter", "2"]
    got = {}
    for name, server, cli in (("port", _port_server("count", data_dir), pmain),
                              ("jax", _jax_server("count", data_dir), jmain)):
        port = _free_port()
        t = _start_server(server, port)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli(["train", *args, "-remote", f"127.0.0.1:{port}"])
        assert rc == 0
        RemoteWorker("127.0.0.1", port).quit()
        t.join(timeout=5)
        got[name] = json.loads(out.getvalue())
    assert _mismatches(got["port"], got["jax"], 2e-3, 1e-4,
                       skip="/refBase") == []


# ---------------------------------------------------------------- CLI server


def test_server_from_args_loads_like_cmd_server(data_dir):
    """`server count` loads its reads without qualities (so its jobs take
    the exact engine) and `-threads 2` means two ports."""
    d = str(data_dir / "c8f30.fastq.gz")
    server, job, port = server_from_args(
        deque(["count", "-ref", d, "-read", d, "-port", "9123", "-threads",
               "2", "-fwdstrand"]), {})
    assert (job, port, server.n_ports) == (None, 9123, 2)
    assert not any(y.has_qual() for y in server.reads)
    server, job, _ = server_from_args(
        deque(["align", d, d, "-job", "info.json"]), {})
    assert job == "info.json" and all(y.has_qual() for y in server.reads)
    assert len(server.refs) == 2 * len(server.reads)  # reverse complements


def test_two_ports_give_the_same_blocks(data_dir):
    """`server align -threads 2` serves two ports; two client workers write
    each read's block in reply order, the same multiset of blocks under the
    same header as one worker's read-order run (and the golden)."""
    d = str(data_dir)
    server, _, _ = server_from_args(
        deque(["align", d + "/synth12-genome.fasta", d + "/synth12.fastq",
               "-kmatchn", "10", "-nothreshold", "-threads", "2"]), {})
    port = _free_pair()
    t = _start_server(server, port, server.n_ports)
    refs = read_fast_seqs(d + "/synth12-genome.fasta")
    from quaff_tpu_torch.io.fastseq import add_revcomps

    refs = add_revcomps(refs)
    reads = read_fast_seqs(d + "/synth12.fastq")
    one, two = io.StringIO(), io.StringIO()
    # a port serves one connection at a time: each run closes its own
    w = RemoteWorker("127.0.0.1", port)
    remote_align_all(one, [w], reads, refs, server.printer)
    w.close()
    ws = [RemoteWorker("127.0.0.1", port), RemoteWorker("127.0.0.1", port + 1)]
    remote_align_all(two, ws, reads, refs, server.printer)
    for x in ws:
        x.close()
    RemoteWorker("127.0.0.1", port).quit()
    t.join(timeout=5)
    assert one.getvalue() == (data_dir / "synth12-align.oracle.stk").read_text()
    head, blocks = _blocks(one.getvalue())
    head2, blocks2 = _blocks(two.getvalue())
    assert head2 == head and sorted(blocks2) == sorted(blocks)
    assert len(blocks) == len(reads)


def _free_pair() -> int:
    """A port p with p + 1 free too."""
    for _ in range(50):
        p = _free_port()
        try:
            with socket.socket() as s:
                s.bind(("", p + 1))
            return p
        except OSError:
            continue
    raise RuntimeError("no two free ports")


def _blocks(text):
    """Stockholm text as (header, [per-read block]): a block starts at its
    "# STOCKHOLM" line and ends with its "//" line."""
    import re

    head = text[:text.find("# STOCKHOLM")]
    blocks = [b + "//\n" for b in re.split(r"(?m)^//\n", text[len(head):])[:-1]]
    assert head + "".join(blocks) == text
    return head, blocks


def test_server_on_cuda_without_a_card_never_reports_ready(data_dir):
    """A worker asked for a card on a host without one fails before it
    prints "# READY": no hidden fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    d = str(data_dir / "c8f30.fastq.gz")
    env = dict(os.environ, QUAFF_TORCH_DEVICE="cuda")
    res = subprocess.run(
        [sys.executable, "-m", "quaff_tpu_torch.cli", "server", "align", d, d,
         "-port", str(_free_port())],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert READY not in res.stdout
    assert "QUAFF_TORCH_DEVICE=cuda" in res.stderr


def _reachable_from(root, kind):
    """Objects of type `kind` reachable from `root` through gc referents
    (not through modules or classes)."""
    import types

    seen, found, stack = set(), [], [root]
    while stack:
        obj = stack.pop()
        if id(obj) in seen or isinstance(obj, (types.ModuleType, type)):
            continue
        seen.add(id(obj))
        if isinstance(obj, kind):
            found.append(obj)
        stack.extend(gc.get_referents(obj))
    return found


def test_no_kmer_index_outlives_its_job(data_dir):
    """A long-lived align server keeps no read's k-mer index (4^k+1 int32
    per read natively) once a job returns."""
    server = _port_server("align", data_dir)
    for y in server.reads * 3:
        assert server.handle_job({"yName": y.name})
    gc.collect()
    assert _reachable_from(server, KmerIndex) == []
    # the check sees an index the server would hold
    server.kept = KmerIndex(server.reads[0], 6)
    assert len(_reachable_from(server, KmerIndex)) == 1


# ---------------------------------------------------------------- failures


class DyingWorker(RemoteWorker):
    """A worker whose connection dies after N successful requests: the
    client's view of a killed remote server."""

    def __init__(self, addr, port, die_after: int):
        super().__init__(addr, port)
        self.served = 0
        self.die_after = die_after

    def request(self, payload: str) -> str:
        if self.served >= self.die_after:
            self.close()
            raise ConnectionError("worker killed mid-run")
        reply = super().request(payload)
        self.served += 1
        return reply


@pytest.fixture(scope="module")
def count_setup():
    """Four synth12 reads against the synth12 genome, without qualities as
    `server count` loads them (the exact engine, ~0.5 s a job on a CPU)."""
    data = pathlib.Path(__file__).parent / "data"
    refs = read_fast_seqs(str(data / "synth12-genome.fasta"))
    reads = read_fast_seqs(str(data / "synth12.fastq"))[:4]
    for r in refs + reads:
        r.qual = ""
    cfg = DPConfig(kmer_threshold=10, device="cpu")
    return refs, reads, default_params(), QuaffNullParams.fit(reads), cfg


def _serve_counts(refs, reads, cfg, n):
    ports = []
    for _ in range(n):
        port = _free_port()
        _start_server(QuaffServer("count", cfg, refs, reads, len(reads)), port)
        ports.append(port)
    return ports


def _fingerprint(total, loglike, orders) -> str:
    buf = io.StringIO()
    total.write_json(buf)
    return json.dumps({"counts": buf.getvalue(), "loglike": f"{loglike:.10g}",
                       "orders": orders})


def test_worker_killed_midrun_drains_identically(count_setup):
    refs, reads, params, null, cfg = count_setup
    assert len(reads) >= 3
    (port,) = _serve_counts(refs, reads, cfg, 1)
    w = RemoteWorker("localhost", port)
    want = _fingerprint(*remote_get_counts([w], refs, reads, params, null))
    w.quit()
    ports = _serve_counts(refs, reads, cfg, 2)
    healthy = RemoteWorker("localhost", ports[0])
    dying = DyingWorker("localhost", ports[1], die_after=1)
    got = _fingerprint(*remote_get_counts([healthy, dying], refs, reads,
                                          params, null))
    healthy.quit()
    RemoteWorker("localhost", ports[1]).quit()
    assert got == want


def test_all_workers_dead_raises(count_setup):
    refs, reads, params, null, cfg = count_setup
    ports = _serve_counts(refs, reads, cfg, 2)
    workers = [DyingWorker("localhost", p, die_after=0) for p in ports]
    with pytest.raises(ConnectionError):
        remote_get_counts(workers, refs, reads, params, null)
    for p in ports:
        RemoteWorker("localhost", p).quit()


def test_reply_handler_failure_aborts_instead_of_hanging():
    class OkWorker:
        def request(self, payload):
            return "ok:" + payload

    calls = []

    def handler(item, reply):
        calls.append(item)
        if len(calls) == 2:
            raise ValueError("boom")

    with pytest.raises(ConnectionError):
        _run_remote_workers([OkWorker(), OkWorker()],
                            [(f"t{i}", i) for i in range(6)], handler)
