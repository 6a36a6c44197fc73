"""K1's CUDA kernel (quaff_tpu_torch/csrc/band_fill.cu) against its plain
PyTorch version on the card, on identical inputs.  Needs an NVIDIA GPU and
skips without one.  This file imports no JAX, so it also runs on a host
that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

Tolerance: rtol 1e-5 / atol 1e-3, the TPU kernel's own: the kernel sums
its delete chain and its Forward end reduction in another order.
"""

import pathlib

import numpy as np
import pytest
import torch

from quaff_tpu.envelope import full_envelope, sparse_envelope
from quaff_tpu.io.fastseq import FastSeq, KmerIndex
from quaff_tpu.model.params import QuaffParams, default_params
from quaff_tpu_torch.dp import fill_v2
from quaff_tpu_torch.dp.engine import PairBatch, to_device
from quaff_tpu_torch.dp.scores import ScoreTables

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


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "forward", "global", "noqual",
                                  "gaporder1", "window", "wide"])
def test_kernel_matches_plain(case):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(31)
    params = (QuaffParams.from_json((DATA / "params-gaporder1.json").read_text())
              if case == "gaporder1" else default_params())
    tt = ScoreTables.from_params(params)
    if case == "wide":
        # a full envelope wider than the block's shared memory holds: the
        # row state lives in global scratch
        from quaff_tpu_torch import kernels

        limit = kernels.max_smem_lanes(torch.cuda.current_device())
        xs = "".join("ACGT"[t] for t in rng.integers(0, 4, limit + 500))
        x = FastSeq(name="x", seq=xs)
        y = FastSeq(name="y", seq=xs[1000:1200], qual="5" * 200)
        pb = PairBatch.build([(x, y, full_envelope(len(xs), 200))] * 2, tt)
        assert pb.member.shape[1] > limit
    elif case == "window":
        pb = PairBatch.build(_pairs(rng, 6, repeat=False), tt)
    elif case == "global":
        # full envelopes: every global path (whole ref, whole read) exists
        pb = PairBatch.build(
            [(x, y, full_envelope(len(x.seq), len(y.seq)))
             for x, y, _ in _pairs(rng, 6, repeat=False)], tt
        )
    else:
        pb = PairBatch.build_packed(
            _pairs(rng, 6, with_qual=case != "noqual"), tt
        )
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
