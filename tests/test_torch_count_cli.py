"""`count` through the PyTorch port on the CPU, against the reference
goldens and the JAX package, and the fused E-step's chunking.

Plain `count` is the float64 parity artifact of the exact engine on the
host; `count -fast` is the training E-step's own route (float32 engine on
the CPU).  The fused E-step (K2 + K3 through their plain versions) is
forced here by routing reads to it as a card would.
"""

import io
import json

import numpy as np
import pytest

from quaff_tpu_torch import trainer
from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.io.fastseq import FastSeq
from quaff_tpu_torch.model.params import QuaffNullParams, default_params
from test_torch_train import _mismatches, _route_to_kernel, _run


@pytest.fixture(autouse=True)
def _cpu_device(monkeypatch):
    monkeypatch.setenv("QUAFF_TORCH_DEVICE", "cpu")


def _synth12(data_dir, *extra):
    return ["count", str(data_dir / "synth12-genome.fasta"),
            str(data_dir / "synth12.fastq"), "-kmatchn", "10", "-fwdstrand",
            *extra]


def test_count_matches_jax_count(data_dir):
    """Plain `count`, the float64 parity artifact, byte for byte the JAX
    package's on synth12."""
    from quaff_tpu.cli import main as jax_main

    rc, mine = _run(_synth12(data_dir))
    assert rc == 0
    rc, want = _run(_synth12(data_dir), jax_main)
    assert rc == 0
    assert mine == want


def test_multiref_counts(data_dir):
    rc, out = _run(["count", str(data_dir / "multiref.fasta"),
                    str(data_dir / "c8f30.fastq.gz"), "-kmatchmb", "10",
                    "-fwdstrand"])
    assert rc == 0
    assert out == (data_dir / "multiref-count.oracle.json").read_text().rstrip("\n")


@pytest.mark.parametrize("route", ["engine", "kernel"])
def test_count_fast_matches_parity(data_dir, route, monkeypatch):
    """`count -fast` within 5e-3 + 5e-3*|count| of the parity artifact
    (tests/test_count_fast.py's documented tolerance), by the float32
    engine and by K2 + K3 (the parity count is taken first: the kernel
    route is forced for every counter)."""
    rc, parity = _run(_synth12(data_dir))
    assert rc == 0
    if route == "kernel":
        _route_to_kernel(monkeypatch)
    rc, fast = _run(_synth12(data_dir, "-fast"))
    assert rc == 0
    parity, fast = json.loads(parity), json.loads(fast)
    assert _mismatches(fast, parity, 5e-3, 5e-3) == []


def _chunking_inputs():
    """tests/test_pallas_counts.py's mixed-length reads against two
    overlapping refs."""
    rng = np.random.default_rng(31)
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 2200))
    refs = [FastSeq(name="refA", seq=base[:1600]),
            FastSeq(name="refB", seq=base[400:2200])]
    reads = []
    for i, (s0, ln) in enumerate([(100, 600), (300, 1100), (700, 800),
                                  (900, 500)]):
        seq = list(base[s0 : s0 + ln])
        for _ in range(int(ln * 0.06)):
            p = int(rng.integers(0, ln))
            seq[p] = "acgt"[int(rng.integers(0, 4))]
        reads.append(FastSeq(name=f"r{i}", seq="".join(seq), qual="".join(
            chr(33 + int(q)) for q in rng.integers(3, 40, ln))))
    return refs, reads


@pytest.mark.parametrize("budget", [None, 2 << 20])
def test_batched_chunking_matches_exact(budget, monkeypatch):
    """The cross-read fused E-step (whole reads per chunk, longest first,
    chunks cut by the byte budget) reproduces the exact per-read path's
    totals, log-likelihood and ref orders.  A small budget cuts the reads
    into one chunk per read."""
    refs, reads = _chunking_inputs()
    null = QuaffNullParams.fit(reads)
    config = DPConfig()
    sort_order = [list(range(len(refs))) for _ in reads]
    exact = trainer.QuaffCounter(default_params(), null, config)
    want_counts, want_ll, want_so = exact.get_counts(refs, reads, sort_order)

    from quaff_tpu_torch.dp import estep

    calls = []
    orig = estep.estep_fused_multi

    def spy(v2tab, batch, gid, null_lls, **kw):
        calls.append(len(set(int(g) for g in gid)))
        return orig(v2tab, batch, gid, null_lls, **kw)

    monkeypatch.setattr(estep, "estep_fused_multi", spy)
    if budget is not None:
        monkeypatch.setattr(trainer, "ESTEP_CHUNK_BYTES", budget)
    _route_to_kernel(monkeypatch)
    kern = trainer.QuaffCounter(default_params(), null, config)
    got_counts, got_ll, got_so = kern.get_counts(refs, reads, sort_order)
    assert sum(calls) == len(reads)
    assert len(calls) == (1 if budget is None else len(reads))
    assert got_so == want_so
    np.testing.assert_allclose(got_ll, want_ll, rtol=1e-5)
    a, b = io.StringIO(), io.StringIO()
    want_counts.write_json(a)
    got_counts.write_json(b)
    assert _mismatches(json.loads(b.getvalue()), json.loads(a.getvalue()),
                       5e-3, 5e-3) == []


def test_oversize_reads_take_the_engine(monkeypatch):
    """A read whose band is wider than a chunk can hold is counted by the
    exact engine, inside the fused path's totals."""
    refs, reads = _chunking_inputs()
    null = QuaffNullParams.fit(reads)
    want = trainer.QuaffCounter(default_params(), null,
                                DPConfig()).get_counts(refs, reads)
    _route_to_kernel(monkeypatch)
    monkeypatch.setattr(trainer, "ESTEP_CHUNK_BYTES", 1 << 10)
    engine_reads = []
    orig = trainer.QuaffCounter.count_read

    def spy(self, refs, y, order, force_engine=False):
        engine_reads.append((y.name, force_engine))
        return orig(self, refs, y, order, force_engine)

    monkeypatch.setattr(trainer.QuaffCounter, "count_read", spy)
    counter = trainer.QuaffCounter(default_params(), null, DPConfig())
    counts, ll, orders = counter.get_counts(refs, reads)
    assert engine_reads == [(y.name, True) for y in reads]
    assert (ll, orders) == want[1:]
    a, b = io.StringIO(), io.StringIO()
    counts.write_json(a)
    want[0].write_json(b)
    assert a.getvalue() == b.getvalue()


def _pair_bytes(width, rows, x_len):
    return 100 * width * rows + x_len


def test_estep_chunk_plan():
    """The chunk plan: a read wider than the lane cap, or whose pairs
    together exceed the budget, goes to the exact engine; the rest form
    chunks of whole reads, longest first, cut where the chunk's padded
    shape (widest band, first read's rows, longest ref) would pass the
    budget."""
    reads = [(0, 50, 10, [100, 200]),     # 2 pairs of 50k + ref
             (1, 80, 10, [100]),          # the longest read
             (2, 60, 5000, [100]),        # wider than the lane cap
             (3, 70, 20, [100] * 3),      # 3 x 140k: over the budget
             (4, 40, 30, [300])]
    chunks, oversize = trainer.estep_chunk_plan(
        reads, _pair_bytes, lane_cap=4096, budget=400_000)
    assert oversize == [2, 3]
    # read 1 alone: 80 rows; + read 0 at (10 lanes, 80 rows): 3 pairs of
    # 80.2k; + read 4 at 30 lanes: 4 x 240.3k > 400k, a new chunk
    assert chunks == [[1, 0], [4]]
    # at a large budget only the lane cap sends a read to the engine
    assert trainer.estep_chunk_plan(reads, _pair_bytes, lane_cap=4096,
                                    budget=10**9)[1] == [2]
    assert trainer.estep_chunk_plan(reads, _pair_bytes, budget=10**9) == (
        [[1, 3, 2, 0, 4]], [])
    # a read alone in a chunk is never cut, whatever the budget
    assert trainer.estep_chunk_plan(reads[:2], _pair_bytes, budget=1) == (
        [], [0, 1])
    assert trainer.estep_chunk_plan(reads[:2], _pair_bytes) == ([[1, 0]], [])


@pytest.mark.parametrize("free", ["small", "large", "raises"])
def test_chunk_plan_ignores_free_memory(free, monkeypatch):
    """The fused E-step's chunk plan decides the output (which reads share
    a chunk, which take the exact engine), so it must not follow the
    card's free memory: with torch.cuda.mem_get_info reporting 1 MiB free,
    80 GB free, or raising, get_counts makes the same chunks and the same
    counts as with the default budget alone."""
    import torch

    refs, reads = _chunking_inputs()
    null = QuaffNullParams.fit(reads)
    _route_to_kernel(monkeypatch)
    plans = []
    orig = trainer.estep_chunk_plan

    def spy(*a, **kw):
        plans.append(orig(*a, **kw))
        return plans[-1]

    monkeypatch.setattr(trainer, "estep_chunk_plan", spy)
    want = trainer.QuaffCounter(default_params(), null, DPConfig())
    want_counts, want_ll, want_so = want.get_counts(refs, reads)

    def mem_get_info(device=None):
        if free == "raises":
            raise RuntimeError("mem_get_info must not decide the chunk plan")
        return (1 << 20 if free == "small" else 80 * 10**9, 80 * 10**9)

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    got = trainer.QuaffCounter(default_params(), null, DPConfig())
    got_counts, got_ll, got_so = got.get_counts(refs, reads)
    assert len(plans) == 2 and plans[0] == plans[1]
    assert plans[0] == ([[1, 2, 0, 3]], [])
    assert (got_ll, got_so) == (want_ll, want_so)
    a, b = io.StringIO(), io.StringIO()
    want_counts.write_json(a)
    got_counts.write_json(b)
    assert a.getvalue() == b.getvalue()
