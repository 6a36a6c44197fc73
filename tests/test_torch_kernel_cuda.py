"""The port's CUDA kernels against their plain PyTorch versions on the
card, on identical inputs: K1 (quaff_tpu_torch/csrc/band_fill.cu), and K2,
K3 and the count reduction (csrc/estep.cu).  Needs an NVIDIA GPU and skips
without one.  This file imports no JAX, so it also runs on a host that has
none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerances, the TPU kernels' own: scores rtol 1e-5 / atol 1e-3 (the
kernels sum their delete chains and Forward end reductions in another
order); counts rtol 3e-3 / atol 5e-3 (tests/test_pallas_counts.py).
"""

import pathlib

import numpy as np
import pytest
import torch

from quaff_tpu_torch.dp import estep, fill_v2
from quaff_tpu_torch.dp.engine import PairBatch, to_device
from quaff_tpu_torch.dp.scores import ScoreTables
from quaff_tpu_torch.envelope import full_envelope, sparse_envelope
from quaff_tpu_torch.io.fastseq import FastSeq, KmerIndex
from quaff_tpu_torch.model.params import QuaffParams, default_params

DATA = pathlib.Path(__file__).resolve().parent / "data"


def _pairs(rng, n, with_qual=True, repeat=True):
    """Reads from a ref; with repeat=True the ref holds the read's core
    twice, giving two-strip envelopes."""
    out = []
    for b in range(n):
        core = "".join("ACGT"[t] for t in rng.integers(0, 4, 150))
        spacer = "".join("ACGT"[t] for t in rng.integers(0, 4, 120))
        ys = list(core)
        for i in range(len(ys)):
            if rng.random() < 0.08:
                ys[i] = "ACGT"[int(rng.integers(0, 4))]
        qual = ("".join(chr(33 + int(q)) for q in rng.integers(3, 40, len(ys)))
                if with_qual else "")
        x = FastSeq(name=f"x{b}", seq=core + spacer + (core if repeat else ""))
        y = FastSeq(name=f"y{b}", seq="".join(ys), qual=qual)
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=32,
                              kmer_threshold=8)
        out.append((x, y, env))
    return out


def _batch(case, rng, tt):
    if case == "wide":
        # a full envelope wider than the block's shared memory holds: the
        # row state of K1/K2 and of K3 lives in global scratch
        from quaff_tpu_torch import kernels

        dev = torch.cuda.current_device()
        limit = max(kernels.max_smem_lanes(dev),
                    kernels.max_smem_lanes(dev, "bwd_counts"))
        xs = "".join("ACGT"[t] for t in rng.integers(0, 4, limit + 500))
        x = FastSeq(name="x", seq=xs)
        y = FastSeq(name="y", seq=xs[1000:1200], qual="5" * 200)
        pb = PairBatch.build([(x, y, full_envelope(len(xs), 200))] * 2, tt)
        assert pb.member.shape[1] > limit
        return pb
    if case == "window":
        return PairBatch.build(_pairs(rng, 6, repeat=False), tt)
    if case == "global":
        # full envelopes: every global path (whole ref, whole read) exists
        return PairBatch.build(
            [(x, y, full_envelope(len(x.seq), len(y.seq)))
             for x, y, _ in _pairs(rng, 6, repeat=False)], tt
        )
    return PairBatch.build_packed(
        _pairs(rng, 6, with_qual=case != "noqual"), tt
    )


def _tables(case):
    params = (QuaffParams.from_json((DATA / "params-gaporder1.json").read_text())
              if case == "gaporder1" else default_params())
    return ScoreTables.from_params(params)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "forward", "global", "noqual",
                                  "gaporder1", "window", "wide"])
def test_kernel_matches_plain(case):
    _need_card()
    rng = np.random.default_rng(31)
    tt = _tables(case)
    pb = _batch(case, rng, tt)
    mode = "forward" if case == "forward" else "viterbi"
    local = case != "global"
    v2 = fill_v2.V2Tables.from_tables(tt, "cuda")
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    before = fill_v2.band_fill.launches
    got = fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local)
    torch.cuda.synchronize()
    assert fill_v2.band_fill.launches == before + 1
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode, local=local)
    floor = fill_v2.NEG_INF / 2
    got = torch.where(got <= floor, float("-inf"), got).double().cpu().numpy()
    ref = torch.where(ref <= floor, float("-inf"), ref).double().cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin[: len(pb.x_len)].all()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "gaporder1", "global", "wide"])
def test_estep_kernels_match_plain(case):
    """K2, K3 and the reduction against fwd_store_reference,
    bwd_counts_reference and a plain sum, each on the same inputs; then
    the whole E-step twice, with bit-identical count tables."""
    _need_card()
    rng = np.random.default_rng(37)
    tt = _tables(case)
    local = case != "global"
    pb = _batch(case, rng, tt)
    v2 = fill_v2.V2Tables.from_tables(tt, "cuda")
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    n = {k: getattr(estep, k).launches
         for k in ("fwd_store", "bwd_counts", "estep_reduce")}
    fwd, rows, offs = estep.fwd_store(**inp, tables=v2, local=local)
    torch.cuda.synchronize()
    fwd_p, _, _ = estep.fwd_store_reference(**inp, tables=v2, local=local)
    fin = fwd_p > fill_v2.NEG_INF / 2
    assert bool(fin.all())
    np.testing.assert_allclose(fwd.double().cpu(), fwd_p.double().cpu(),
                               rtol=1e-5, atol=1e-3)
    wrow = torch.stack([torch.full_like(fwd, 0.5), fwd]).contiguous()
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
            rows, offs)
    part, sc = estep.bwd_counts(*base, local=local)
    tab = estep.estep_reduce(part)
    torch.cuda.synchronize()
    part_p, sc_p = estep.bwd_counts_reference(*base, local=local)
    for got, want in ((part, part_p), (sc, sc_p),
                      (tab, estep.estep_reduce_reference(part))):
        np.testing.assert_allclose(got.double().cpu(), want.double().cpu(),
                                   rtol=3e-3, atol=5e-3)
    assert float(tab.sum()) > 0
    fwd2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local)
    part2, sc2 = estep.bwd_counts(*base[:6], rows2, offs2, local=local)
    assert torch.equal(fwd, fwd2) and torch.equal(sc, sc2)
    assert torch.equal(tab, estep.estep_reduce(part2))
    assert {k: getattr(estep, k).launches - v for k, v in n.items()} == {
        "fwd_store": 2, "bwd_counts": 2, "estep_reduce": 2}
