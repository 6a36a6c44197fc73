"""`-mesh` through the port's CLI on two gloo ranks on the CPU, against the
goldens that the JAX package's `-mesh` tests hold their own runs to
(tests/test_mesh_align_overlap.py, test_mesh_train.py,
test_multihost_cli.py), and against the port's and the JAX package's
sequential runs.

One pair of rank processes runs every command of the module in one
process group (RANK_JOBS), once: the ranks call the CLI's main() in turn,
as two processes of `-nprocs 2` would.  The CLI's own joining of the
ranks, by flags and by the QUAFF_* environment, is run by two tests of
its own.  Every rank process has a timeout, so a hang fails a test instead
of stalling the suite.
"""

import contextlib
import io
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from quaff_tpu_torch.cli import main

REPO = pathlib.Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
DNA = "ACGT"
RANK_TIMEOUT = 240


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")


def _run(argv, cli=main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env() -> dict:
    """A rank process's environment: the CPU, one intra-op thread (the
    suite runs many processes at once), this checkout first on the path."""
    env = dict(os.environ)
    env.update(QUAFF_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO)] + [
                   p for p in [env.get("PYTHONPATH")] if p]))
    return env


def run_ranks(argvs, timeout=RANK_TIMEOUT):
    """Start one process a rank, argvs[rank], and wait for all: [(rc,
    stdout, stderr)].  On a timeout every process is killed and the test
    fails."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=rank_env(),
                              cwd=str(REPO))
             for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out.decode(), err.decode()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"rank processes did not end within {timeout} s")
    return outs


# A rank of the pair: joins the group, then runs each job's argv through
# the CLI's main(), its stdout, stderr and exit code into <out>/<job>.<rank>.
# A job's "force_global" sends every K1 call through the smem route's global
# tier (the route of bands past shared memory) at its tiling for the band.
RANK_WORKER = r"""
import contextlib, datetime, io, json, sys
coord, rank, jobs_file, out_dir = sys.argv[1:5]
rank = int(rank)
from quaff_tpu_torch.cli import main
from quaff_tpu_torch.dp import fill_v2
from quaff_tpu_torch.parallel.distributed import init_distributed
init_distributed(coord, 2, rank, timeout=datetime.timedelta(seconds=120))
plain_band_fill = fill_v2.band_fill
for name, argv, opts in json.load(open(jobs_file)):
    routes = []
    if opts.get("force_global"):
        def band_fill(*a, **k):
            k["route"] = ("global", fill_v2.global_tiling(
                k["doff"].shape[1], fill_v2.FILL_GLOBAL_WARPS))
            routes.append(k["route"])
            return plain_band_fill(*a, **k)
        fill_v2.band_fill = band_fill
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    fill_v2.band_fill = plain_band_fill
    with open(f"{out_dir}/{name}.{rank}", "w") as f:
        json.dump({"rc": rc, "out": out.getvalue(), "err": err.getvalue(),
                   "routes": routes}, f)
"""


def _train_data(tmp, n_reads=5):
    """tests/test_mesh_train.py:46-84's data with n_reads reads: 5 on two
    ranks pads the second rank's block with a sentinel read."""
    rng = np.random.default_rng(57)
    ref_seq = "".join(DNA[t] for t in rng.integers(0, 4, 150))
    (tmp / "ref.fasta").write_text(f">genome\n{ref_seq}\n")
    lines = []
    for i in range(n_reads):
        start = int(rng.integers(0, 30))
        toks = [int(rng.integers(0, 4)) if rng.random() < 0.05
                else DNA.index(c) for c in ref_seq[start : start + 100]]
        seq = "".join(DNA[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        lines.append(f"@read{i}\n{seq}\n+\n{qual}\n")
    (tmp / "reads.fastq").write_text("".join(lines))


def _meshmp_data(tmp):
    """tests/test_mesh_train.py:87-121's data: genome plus its revcomp."""
    rng = np.random.default_rng(61)
    ref_seq = "".join(DNA[t] for t in rng.integers(0, 4, 140))
    (tmp / "ref2.fasta").write_text(f">genome\n{ref_seq}\n")
    lines = []
    for i in range(4):
        toks = [int(rng.integers(0, 4)) if rng.random() < 0.05
                else DNA.index(c) for c in ref_seq[10:110]]
        seq = "".join(DNA[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        lines.append(f"@read{i}\n{seq}\n+\n{qual}\n")
    (tmp / "reads2.fastq").write_text("".join(lines))


def _synth12_align():
    return ["align", str(DATA / "synth12-genome.fasta"),
            str(DATA / "synth12.fastq"), "-kmatchn", "10", "-nothreshold"]


# (job, argv, golden) of the align goldens a -mesh run must give byte for
# byte: the sequential runs' (tests/test_torch_align.py), covering
# tests/test_mesh_align_overlap.py's -printall, SAM and global cases
ALIGN_GOLDENS = [
    ("printall", ["multiref.fasta", "c8f30.fastq.gz", "-kmatchmb", "10",
                  "-fwdstrand", "-printall"], "multiref-printall.oracle.txt"),
    ("sam", ["synth12-genome.fasta", "synth12.fastq", "-kmatchn", "10",
             "-nothreshold", "-format", "sam"], "synth12-align.oracle.sam"),
    ("global", ["c8f30.fastq.gz", "c8f30.fastq.gz", "-kmatchmb", "10",
                "-fwdstrand", "-global"], "c8f30-global-align.oracle.txt"),
]


def _golden_align(argv):
    return ["align"] + [str(DATA / a) if "." in a else a for a in argv]


def _train(tmp, *extra):
    return ["train", str(tmp / "ref.fasta"), str(tmp / "reads.fastq"),
            "-fwdstrand", "-force", "-maxiter", "2", *extra]


def _train_mp(tmp, *extra):
    return ["train", str(tmp / "ref2.fasta"), str(tmp / "reads2.fastq"),
            "-force", "-maxiter", "2", *extra]


def _count(tmp, *extra):
    return ["count", str(tmp / "ref.fasta"), str(tmp / "reads.fastq"),
            "-fwdstrand", *extra]


def rank_jobs(tmp):
    """Every job of the pair: (name, argv, options)."""
    ckpt = str(tmp / "ckpt")
    return [
        ("align", _synth12_align() + ["-mesh"], {}),
        ("align_wide", _synth12_align() + ["-mesh"], {"force_global": True}),
        *((job, _golden_align(argv) + ["-mesh"], {})
          for job, argv, _ in ALIGN_GOLDENS),
        ("overlap", ["overlap", str(DATA / "synth12.fastq"), "-kmatchn",
                     "10", "-nothreshold", "-mesh"], {}),
        ("train", _train(tmp, "-mesh"), {}),
        ("meshmp", _train_mp(tmp, "-meshmp", "2"), {}),
        ("meshmp_refused", _train(tmp, "-meshmp", "2"), {}),
        ("count_fast", _count(tmp, "-fast", "-mesh", "-v"), {}),
        ("count_plain", _count(tmp, "-mesh", "-v"), {}),
        # per-rank checkpoint dirs, as on ranks with no shared filesystem:
        # the first run writes rank 0's only, the second resumes it there
        ("ckpt_first", _train(tmp, "-mesh", "-checkpoint", ckpt), {}),
        ("ckpt_again", _train(tmp, "-mesh", "-checkpoint", ckpt), {}),
    ]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs rank_jobs on two gloo ranks once: {job: [rank 0's, rank 1's]},
    each {"rc", "out", "err", "routes"}; the data dir is under "tmp"."""
    tmp = tmp_path_factory.mktemp("mesh_cli")
    _train_data(tmp)
    _meshmp_data(tmp)
    jobs = rank_jobs(tmp)
    # the checkpoint dir of each rank: rank 0's is the one it writes
    jobs_of = []
    for rank in (0, 1):
        js = [(n, [a.replace(str(tmp / "ckpt"), str(tmp / f"ckpt{rank}"))
                   for a in argv], o) for n, argv, o in jobs]
        (tmp / f"jobs{rank}.json").write_text(json.dumps(js))
        jobs_of.append(tmp / f"jobs{rank}.json")
    out_dir = tmp / "out"
    out_dir.mkdir()
    coord = f"localhost:{_free_port()}"
    outs = run_ranks([[sys.executable, "-c", RANK_WORKER, coord, str(r),
                       str(jobs_of[r]), str(out_dir)] for r in (0, 1)])
    for rank, (rc, _, err) in enumerate(outs):
        assert rc == 0, f"rank {rank} failed:\n{err[-3000:]}"
    res = {n: [json.loads((out_dir / f"{n}.{r}").read_text()) for r in (0, 1)]
           for n, _, _ in jobs}
    res["tmp"] = tmp
    return res


def _ok(ranks, name):
    """Rank 0's output of a job that both ranks ran without error; rank 1
    wrote nothing."""
    r0, r1 = ranks[name]
    assert r0["rc"] == 0 and r1["rc"] == 0, (r0["err"], r1["err"])
    assert r1["out"] == ""
    return r0["out"]


def _json_close(mine, want, rtol, atol):
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
        elif isinstance(a, (int, float)) and not isinstance(a, bool):
            if not abs(float(a) - float(b)) <= atol + rtol * abs(float(b)):
                bad.append((path, a, b))
        else:
            assert a == b, path

    walk(mine, want, "")
    return bad


def test_mesh_align_synth12_golden(ranks):
    """tests/test_mesh_align_overlap.py:33-44: the -mesh text is the
    sequential text, synth12-align.oracle.stk."""
    assert _ok(ranks, "align") == (DATA / "synth12-align.oracle.stk").read_text()


def test_mesh_align_wide_band_on_k1_block_route(ranks):
    """The counterpart of test_mesh_align_wide_band_sp_fill: every chunk of
    an align -mesh run forced onto K1's smem route's global tier, the route
    of bands too wide for shared memory (its plain version on the CPU), and
    the text still the golden.  The port shares no band over ranks
    (parallel/spfill.py is not ported): a chunk of any width stays on one
    rank."""
    assert (_ok(ranks, "align_wide")
            == (DATA / "synth12-align.oracle.stk").read_text())
    routes = [r for rank in ranks["align_wide"] for r in rank["routes"]]
    assert routes and all(r[0] == "global" and len(r[1]) == 3
                          for r in routes)


@pytest.mark.parametrize("job,golden",
                         [(job, golden) for job, _, golden in ALIGN_GOLDENS])
def test_mesh_align_goldens(ranks, job, golden):
    """tests/test_mesh_align_overlap.py:47-58 and :96-107's -printall, SAM
    and global modes: the -mesh text is the sequential golden."""
    assert _ok(ranks, job) == (DATA / golden).read_text()


def test_mesh_overlap_synth12_golden(ranks):
    assert (_ok(ranks, "overlap")
            == (DATA / "synth12-overlap.oracle.stk").read_text())


def test_mesh_train_matches_sequential(ranks):
    """tests/test_mesh_train.py's check on 5 reads (a sentinel read pads
    rank 1): within rtol 1e-6 of the port's and the JAX package's
    sequential train."""
    from quaff_tpu.cli import main as jax_main

    tmp = ranks["tmp"]
    mesh = json.loads(_ok(ranks, "train"))
    rc, seq = _run(_train(tmp))
    assert rc == 0
    rc, jax_seq = _run(_train(tmp), jax_main)
    assert rc == 0
    assert _json_close(mesh, json.loads(seq), 1e-6, 1e-12) == []
    assert _json_close(mesh, json.loads(jax_seq), 1e-6, 1e-12) == []


def test_meshmp_ref_axis(ranks):
    """-meshmp 2 on two ranks (1 x 2: genome and its revcomp on a rank
    each): within rtol 1e-6 of the port's sequential train."""
    rc, seq = _run(_train_mp(ranks["tmp"]))
    assert rc == 0
    assert _json_close(json.loads(_ok(ranks, "meshmp")), json.loads(seq),
                       1e-6, 1e-12) == []


def test_meshmp_rejects_nondivisible_refs(ranks):
    """One ref (-fwdstrand) does not divide mp = 2: refused on both ranks."""
    for r in ranks["meshmp_refused"]:
        assert r["rc"] != 0
        assert "must divide" in r["err"]


def test_mesh_count_fast_matches_one_process(ranks):
    """count -fast -mesh on two ranks within the count tolerance (rtol
    3e-3, atol 5e-3, tests/test_pallas_counts.py:77-88) of one process's
    count -fast."""
    rc, one = _run(_count(ranks["tmp"], "-fast"))
    assert rc == 0
    assert _json_close(json.loads(_ok(ranks, "count_fast")), json.loads(one),
                       3e-3, 5e-3) == []


def test_mesh_count_without_fast_is_the_parity_artifact(ranks):
    """count -mesh without -fast: -mesh is logged as ignored, and the JSON
    is one process's plain count."""
    rc, one = _run(_count(ranks["tmp"]))
    assert rc == 0
    assert _ok(ranks, "count_plain") == one
    assert all("-mesh ignored without -fast" in r["err"]
               for r in ranks["count_plain"])


def test_checkpoint_desync_detected(ranks):
    """tests/test_multihost_cli.py:217-236: rank 0 alone writes the EM
    checkpoint; with per-rank directories the second run resumes on rank 0
    only, and both ranks fail with "desync" instead of diverging."""
    for r in ranks["ckpt_first"]:
        assert r["rc"] == 0, r["err"]
    assert (ranks["tmp"] / "ckpt0" / "state.json").exists()
    assert not (ranks["tmp"] / "ckpt1").exists()
    for r in ranks["ckpt_again"]:
        assert r["rc"] != 0
        assert "desync" in r["err"] and "shared filesystem" in r["err"]


def _cli(*argv):
    return [sys.executable, "-m", "quaff_tpu_torch.cli", *argv]


def test_flags_join_ranks(tmp_path):
    """-coordinator/-nprocs/-procid join two CLI processes: rank 0 writes
    the one-process text, rank 1 nothing."""
    argv = ["align", str(DATA / "tiny.fasta"), str(DATA / "tiny.fastq"),
            "-nothreshold", "-mesh"]
    rc, want = _run(argv)
    assert rc == 0
    coord = f"localhost:{_free_port()}"
    outs = run_ranks([_cli(*argv, "-coordinator", coord, "-nprocs", "2",
                           "-procid", str(r)) for r in (0, 1)])
    assert [o[0] for o in outs] == [0, 0], outs[0][2][-2000:]
    assert outs[0][1] == want
    assert outs[1][1] == ""


def test_nprocs_without_mesh_fails(tmp_path):
    """tests/test_multihost_cli.py:239-274: two ranks joined through
    QUAFF_COORDINATOR/QUAFF_NPROCS/QUAFF_PROCID, `train` without -mesh:
    both exit non-zero with "require -mesh"."""
    _train_data(tmp_path)
    coord = f"localhost:{_free_port()}"
    env = rank_env()
    procs = []
    for r in (0, 1):
        e = dict(env, QUAFF_COORDINATOR=coord, QUAFF_NPROCS="2",
                 QUAFF_PROCID=str(r))
        procs.append(subprocess.Popen(
            _cli(*_train(tmp_path)[:-2], "-maxiter", "1"),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=e))
    for p in procs:
        try:
            _, err = p.communicate(timeout=RANK_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("ranks hung instead of failing")
        assert p.returncode != 0
        assert b"require -mesh" in err
