"""The port's batch layout, score tables and float64 engine
(quaff_tpu_torch/dp/{scores,engine}.py) against the JAX package.

The layout and tables must be equal array for array.  The float64 engine
is the port's parity path: Viterbi scores and M/I/D matrices must equal
JAX's float64 dp_fill exactly (its delete recurrence runs lane by lane
like the reference), Forward to rtol 1e-12 (log-add-exp rounds in the
last bits differently in the two libraries).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quaff_tpu.dp import engine as jax_engine
from quaff_tpu.dp.scores import ScoreTables as JaxScoreTables
from quaff_tpu.envelope import full_envelope
from quaff_tpu.model.params import QuaffParams, default_params
from quaff_tpu_torch.dp import engine
from quaff_tpu_torch.dp.scores import ScoreTables
from test_pallas_v2 import _random_pairs
from test_strips import _synthetic_multistrip

_BATCH_FIELDS = (
    "x_tok", "x_len", "y_tok", "y_match_kmer", "y_indel_kmer_pad", "y_qual",
    "y_has_qual", "y_len", "d_lo", "member", "seg_d_lo", "seg_start",
    "seg_width",
)


def _params(kind, data_dir):
    if kind == "gaporder1":
        return QuaffParams.from_json(
            (data_dir / "params-gaporder1.json").read_text()
        )
    return default_params()


@pytest.mark.parametrize("kind", ["default", "gaporder1"])
def test_score_tables_match_reference(kind, data_dir):
    qp = _params(kind, data_dir)
    mine = ScoreTables.from_params(qp)
    ref = JaxScoreTables.from_params(qp)
    for name in ("match_score", "match_score_noq", "insert_score",
                 "insert_score_noq", "m2m", "m2i", "m2d", "m2e",
                 "d2d", "d2m", "i2i", "i2m", "match_kmer_len",
                 "indel_kmer_len"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name),
                                      err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
def test_pair_batch_matches_reference(packed):
    rng = np.random.default_rng(17)
    tt = ScoreTables.from_params(default_params())
    jt = JaxScoreTables.from_params(default_params())
    pairs = _synthetic_multistrip(rng, 3) + _random_pairs(rng, 2)
    if packed:
        mine = engine.PairBatch.build_packed(pairs, tt)
        ref = jax_engine.PairBatch.build_packed(pairs, jt)
    else:
        mine = engine.PairBatch.build(pairs, tt, width=300, max_y_len=200)
        ref = jax_engine.PairBatch.build(pairs, jt, width=300, max_y_len=200)
    for name in _BATCH_FIELDS:
        a, b = getattr(mine, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (mine.width, mine.max_y_len) == (ref.width, ref.max_y_len)
    # to_device keeps host_batch's keys and narrowed dtypes
    dev = engine.to_device(mine, "cpu")
    host = jax_engine.host_batch(ref)
    assert set(dev) == set(host)
    for k in host:
        assert dev[k].numpy().dtype == host[k].dtype, k
        np.testing.assert_array_equal(dev[k].numpy(), host[k], err_msg=k)


def test_pow2ceil_matches_reference():
    for n in (0, 1, 7, 8, 9, 100, 2048, 2049):
        assert engine.pow2ceil(n) == jax_engine.pow2ceil(n)


@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("kind", ["default", "gaporder1"])
def test_dp_fill_f64_matches_reference(mode, local, kind, data_dir):
    rng = np.random.default_rng(3)
    qp = _params(kind, data_dir)
    tt, jt = ScoreTables.from_params(qp), JaxScoreTables.from_params(qp)
    pairs = _random_pairs(rng, 4) + _random_pairs(rng, 1, with_qual=False)
    x, y, _ = pairs[3]
    pairs[3] = (x, y, full_envelope(len(x.seq), len(y.seq)))
    ref = jax_engine.dp_fill(
        jax_engine.device_tables(jt),
        jax_engine.device_batch(jax_engine.PairBatch.build(pairs, jt)),
        mode=mode, local=local, return_matrices=True, dtype=jnp.float64,
    )
    got = engine.dp_fill(
        engine.table_tensors(tt),
        engine.to_device(engine.PairBatch.build(pairs, tt), "cpu"),
        mode=mode, local=local, return_matrices=True, dtype=torch.float64,
    )
    for name in ("score", "mat", "ins", "del"):
        a, b = got[name].numpy(), np.asarray(ref[name])
        if mode == "viterbi":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
            fin = np.isfinite(b)
            np.testing.assert_allclose(a[fin], b[fin], rtol=1e-12, atol=0,
                                       err_msg=name)


def test_c8f30_self_score(data_dir):
    """The c8f30 self-alignment's float64 Viterbi end score equals the JAX
    engine's (the golden's 7981.84 after the null model)."""
    from quaff_tpu.envelope import make_envelope
    from quaff_tpu.io.fastseq import KmerIndex, read_fast_seqs

    y = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))[0]
    x = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))[0]
    x.qual = ""
    env = make_envelope(x, KmerIndex(y, 6), kmer_threshold=-1,
                        cell_size=24, max_size=10 << 20)
    tt = ScoreTables.from_params(default_params())
    jt = JaxScoreTables.from_params(default_params())
    got = engine.dp_fill(
        engine.table_tensors(tt),
        engine.to_device(engine.PairBatch.build([(x, y, env)], tt), "cpu"),
    )["score"].numpy()
    ref = np.asarray(jax_engine.dp_fill(
        jax_engine.device_tables(jt),
        jax_engine.device_batch(jax_engine.PairBatch.build([(x, y, env)], jt)),
        dtype=jnp.float64,
    )["score"])
    np.testing.assert_array_equal(got, ref)


def test_dp_fill_rejects_packed():
    rng = np.random.default_rng(25)
    tt = ScoreTables.from_params(default_params())
    pb = engine.PairBatch.build_packed(_synthetic_multistrip(rng, 2), tt)
    with pytest.raises(ValueError, match="packed"):
        engine.dp_fill(engine.table_tensors(tt), engine.to_device(pb, "cpu"))
