"""quaff_tpu_torch/parallel/ on the CPU: the rank layout against the JAX
package's on the same arguments, and the mesh E-step and scoring on two
gloo ranks against the single-process code.

The two-rank cases run in one pair of rank processes for the module (the
`pair` fixture), each with a timeout."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.io.fastseq import read_fast_seqs
from quaff_tpu_torch.model.params import QuaffNullParams, default_params
from quaff_tpu_torch.parallel import distributed, estep, mesh
from quaff_tpu_torch.trainer import QuaffCounter

REPO = pathlib.Path(__file__).resolve().parent.parent
RANK_TIMEOUT = 240


@pytest.mark.parametrize("n_reads", [0, 1, 5, 8, 13])
@pytest.mark.parametrize("nprocs", [1, 2, 3, 4])
def test_host_read_shard_matches_jax(n_reads, nprocs):
    from quaff_tpu.parallel.distributed import host_read_shard as jax_shard

    reads = list(range(n_reads))
    for pid in range(nprocs):
        assert (distributed.host_read_shard(reads, pid, nprocs)
                == jax_shard(reads, pid, nprocs))


@pytest.mark.parametrize("n,mp", [(1, None), (2, None), (4, None), (6, None),
                                  (8, None), (8, 1), (8, 4), (3, None)])
def test_make_mesh_matches_jax(n, mp):
    """The (dp, mp) grid and its defaults: rank r where JAX's mesh has the
    device of id r (the conftest's 8 CPU devices)."""
    from quaff_tpu.parallel.mesh import make_mesh as jax_make_mesh

    want = jax_make_mesh(n, mp)
    got = mesh.make_mesh(n, mp)
    assert got.shape == dict(want.shape)
    ids = np.vectorize(lambda d: d.id)(want.devices)
    assert np.array_equal(got.ranks, ids)


def test_make_mesh_refuses_what_jax_refuses():
    from quaff_tpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(AssertionError, match="mesh 1x2 != 3 devices"):
        jax_make_mesh(3, 2)
    with pytest.raises(ValueError, match="mesh 1x2 != 3 devices"):
        mesh.make_mesh(3, 2)


def test_one_process_is_a_world_of_one():
    """No group: init_distributed is a no-op for one process, this process
    is primary, a mesh is 1 x 1, and the collectives are the identity."""
    distributed.init_distributed(num_processes=1)
    assert distributed.world() == (0, 1)
    assert distributed.is_primary()
    m = distributed.make_global_mesh(1)
    assert (m.dp, m.mp, m.size) == (1, 1, 1)
    assert list(m.chunks_of_rank(3)) == [0, 1, 2]
    v = np.asarray([1.5, -2.0, 1e-300])
    (g,) = distributed.gather_floats(v)
    assert np.array_equal(g, v)
    assert np.array_equal(distributed.sum_in_rank_order([v]), v)
    assert np.array_equal(distributed.sum_in_rank_order([v, v, -v]),
                          (v + v) - v)
    with pytest.raises(RuntimeError, match="vectors of 3 and 2 values"):
        distributed.sum_in_rank_order([v, v[:2]])
    got = estep.gather_scores({1: np.asarray([2.0]), 0: np.asarray([1.0, 3.0])})
    assert {k: list(v) for k, v in got.items()} == {0: [1.0, 3.0], 1: [2.0]}


def _reads():
    """The train data of tests/test_mesh_train.py:46-84, with 5 reads."""
    DNA = "ACGT"
    rng = np.random.default_rng(57)
    ref = "".join(DNA[t] for t in rng.integers(0, 4, 150))
    reads = []
    for i in range(5):
        start = int(rng.integers(0, 30))
        toks = [int(rng.integers(0, 4)) if rng.random() < 0.05
                else DNA.index(c) for c in ref[start : start + 100]]
        seq = "".join(DNA[t] for t in toks)
        qual = "".join(chr(33 + int(q)) for q in rng.integers(5, 30, len(seq)))
        reads.append(f"@read{i}\n{seq}\n+\n{qual}\n")
    return f">genome\n{ref}\n", "".join(reads)


def test_counts_vector_round_trip():
    from quaff_tpu_torch.model.params import QuaffParamCounts

    c = QuaffParamCounts.zero(2, 1)
    rng = np.random.default_rng(0)
    c.insert, c.match = rng.random(c.insert.shape), rng.random(c.match.shape)
    c.begin_delete_yes = rng.random(c.begin_delete_yes.shape)
    c.extend_insert_yes, c.extend_delete_no = 0.25, 3.5
    back = estep.counts_from_vector(estep.counts_vector(c), 2, 1)
    assert np.array_equal(estep.counts_vector(back), estep.counts_vector(c))
    assert back.extend_delete_no == 3.5


def test_build_pair_grid_matches_jax(tmp_path):
    from quaff_tpu.aligner import DPConfig as JaxConfig
    from quaff_tpu.dp.scores import ScoreTables as JaxTables
    from quaff_tpu.io.fastseq import read_fast_seqs as jax_read
    from quaff_tpu.model.params import default_params as jax_default
    from quaff_tpu.parallel.estep import build_pair_grid as jax_grid
    from quaff_tpu_torch.dp.scores import ScoreTables

    ref, reads = _reads()
    (tmp_path / "r.fa").write_text(ref)
    (tmp_path / "y.fq").write_text(reads)
    mine, ylen = estep.build_pair_grid(
        read_fast_seqs(str(tmp_path / "r.fa")),
        read_fast_seqs(str(tmp_path / "y.fq")),
        ScoreTables.from_params(default_params()), DPConfig(), 48)
    want, ylen_j = jax_grid(
        jax_read(str(tmp_path / "r.fa")), jax_read(str(tmp_path / "y.fq")),
        JaxTables.from_params(jax_default()), JaxConfig(), 48)
    assert np.array_equal(ylen, ylen_j)
    assert mine.keys() == want.keys()
    for k in want:
        assert np.array_equal(mine[k].numpy(), np.asarray(want[k])), k


# One rank of the pair: the provider on the module's data at mp = 1 and 2,
# and sharded_scores, written to <out>.<rank> as JSON.
RANK_WORKER = r"""
import datetime, json, sys
import numpy as np, torch
coord, rank, ref_file, read_file, out = sys.argv[1:6]
rank = int(rank)
from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.io.fastseq import read_fast_seqs
from quaff_tpu_torch.model.params import QuaffNullParams, default_params
from quaff_tpu_torch.parallel import distributed, estep
distributed.init_distributed(coord, 2, rank,
                             timeout=datetime.timedelta(seconds=120))
refs = read_fast_seqs(ref_file)
refs = refs + [r.revcomp() for r in refs]
reads = read_fast_seqs(read_file)
null = QuaffNullParams.fit(reads)
params = default_params()
res = {}
for mp in (1, 2):
    m = distributed.make_global_mesh(mp)
    prov = estep.MeshCountsProvider(m, refs, reads, params, null,
                                    DPConfig(device="cpu"))
    counts, ll, orders = prov(params, [[0, 1] for _ in reads])
    res[f"mp{mp}"] = {"counts": list(estep.counts_vector(counts)),
                      "loglike": ll, "orders": orders,
                      "n_local": len(prov.reads), "real": prov.real}
m = distributed.make_global_mesh(1)
got = estep.sharded_scores(
    m, 5, lambda i: torch.full((i + 1,), float(10 * i + rank)))
res["scores"] = [list(g) for g in got]
json.dump(res, open(f"{out}.{rank}", "w"))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """RANK_WORKER on two gloo ranks, once: [rank 0's, rank 1's] results,
    and the data files."""
    tmp = tmp_path_factory.mktemp("parallel")
    ref, reads = _reads()
    (tmp / "ref.fasta").write_text(ref)
    (tmp / "reads.fastq").write_text(reads)
    env = dict(os.environ, QUAFF_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                                  if p]))
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_WORKER, coord, str(r),
         str(tmp / "ref.fasta"), str(tmp / "reads.fastq"), str(tmp / "res")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env)
        for r in (0, 1)]
    try:
        errs = [p.communicate(timeout=RANK_TIMEOUT)[1] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"rank processes did not end within {RANK_TIMEOUT} s")
    for p, e in zip(procs, errs):
        assert p.returncode == 0, e.decode()[-3000:]
    return ([json.loads((tmp / f"res.{r}").read_text()) for r in (0, 1)],
            tmp)


def _sequential(tmp):
    refs = read_fast_seqs(str(tmp / "ref.fasta"))
    refs = refs + [r.revcomp() for r in refs]
    reads = read_fast_seqs(str(tmp / "reads.fastq"))
    counter = QuaffCounter(default_params(), QuaffNullParams.fit(reads),
                           DPConfig(device="cpu"), dtype=torch.float64)
    return counter.get_counts(refs, reads)


def test_mesh_counts_provider_matches_counter(pair):
    """One MeshCountsProvider iteration on two ranks (5 reads: rank 1's
    block ends in a sentinel read) against QuaffCounter.get_counts on all
    reads in one process, float64 on the CPU: the same totals within rtol
    1e-9, the same log-likelihood and sort orders, on both ranks bit for
    bit the same."""
    (r0, r1), tmp = pair
    for k in ("counts", "loglike", "orders"):
        assert r0["mp1"][k] == r1["mp1"][k]
    assert r0["mp1"]["real"] == [True, True, True]
    assert r1["mp1"]["real"] == [True, True, False]
    counts, ll, orders = _sequential(tmp)
    np.testing.assert_allclose(r0["mp1"]["counts"],
                               estep.counts_vector(counts), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(r0["mp1"]["loglike"], ll, rtol=1e-9)
    assert r0["mp1"]["orders"] == orders


def test_mesh_counts_provider_meshmp(pair):
    """-meshmp 2 (the genome on rank 0, its revcomp on rank 1): every pair
    counted with its exact weight, within rtol 1e-6 of the sequential
    E-step, whose Delta=20 skip drops the revcomp's weights below e^-20
    (about 2e-9 a read: hence atol 1e-6 on counts of 0)."""
    (r0, r1), tmp = pair
    assert r0["mp2"] == r1["mp2"]
    assert r0["mp2"]["n_local"] == 5
    counts, ll, orders = _sequential(tmp)
    np.testing.assert_allclose(r0["mp2"]["counts"],
                               estep.counts_vector(counts), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(r0["mp2"]["loglike"], ll, rtol=1e-9)
    assert r0["mp2"]["orders"] == orders


def test_sharded_scores_deals_chunks_in_turn(pair):
    """Chunk i is scored on rank i % 2 and every chunk comes back to both
    ranks in chunk order."""
    (r0, r1), _ = pair
    want = [[float(10 * i + i % 2)] * (i + 1) for i in range(5)]
    assert r0["scores"] == want and r1["scores"] == want


def test_chip_smoke_holds_traces_to_the_wrappers_counts():
    """chip_smoke.py's phase 8 compares the wrappers' launch counts by
    wrapper and route, keyed as its trace tally keys kernels by name, and
    holds a run's trace to exactly those counts."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    launches = {
        "band_fill": {"launches": 13, "warp_launches": 12,
                      "cluster_launches": 1, "global_launches": 0},
        "fwd_store": {"launches": 0, "warp_launches": 0,
                      "global_launches": 0},
        "estep_reduce": {"launches": 2},
    }
    assert chip_smoke._counted(launches) == {
        "band_fill warp": 12, "band_fill cluster": 1, "estep_reduce": 2}
    whole = {"band_fill warp": [12, 30.0], "band_fill cluster": [1, 5.0],
             "estep_reduce": [2, 0.01]}
    assert chip_smoke._trace_short((None, None, launches, whole)) is None
    for lost in ({**whole, "band_fill warp": [11, 27.5]},
                 {k: v for k, v in whole.items() if k != "estep_reduce"},
                 {**whole, "fwd_store warp": [1, 3.0]}):
        traced, counted = chip_smoke._trace_short((None, None, launches, lost))
        assert traced == {k: v[0] for k, v in lost.items()}
        assert counted == chip_smoke._counted(launches)
