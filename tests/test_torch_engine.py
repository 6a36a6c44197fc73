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
from quaff_tpu.model.params import QuaffParams as JaxQuaffParams
from quaff_tpu.model.params import default_params as jax_default_params
from quaff_tpu_torch.dp import engine
from quaff_tpu_torch.dp.scores import ScoreTables
from quaff_tpu_torch.envelope import Envelope
from quaff_tpu_torch.io.fastseq import FastSeq
from quaff_tpu_torch.model.params import QuaffParams, default_params
from test_pallas_v2 import _random_pairs
from test_strips import _synthetic_multistrip


def port_pairs(pairs):
    """The port's own (ref, read, envelope) objects for the JAX package's:
    sequences and qualities by value, each envelope from its diagonals."""
    return [
        (FastSeq(name=x.name, seq=x.seq, qual=x.qual),
         FastSeq(name=y.name, seq=y.seq, qual=y.qual),
         Envelope(env.x_len, env.y_len, np.array(env.diagonals)))
        for x, y, env in pairs
    ]


def port_params(jax_params):
    """The port's QuaffParams from the JAX package's, through its JSON."""
    import io

    out = io.StringIO()
    jax_params.write_json(out)
    return QuaffParams.from_json(out.getvalue())

_BATCH_FIELDS = (
    "x_tok", "x_len", "y_tok", "y_match_kmer", "y_indel_kmer_pad", "y_qual",
    "y_has_qual", "y_len", "d_lo", "member", "seg_d_lo", "seg_start",
    "seg_width",
)


def _params(kind, data_dir):
    """(JAX params, port params) of one kind, each read by its own side."""
    if kind == "gaporder1":
        text = (data_dir / "params-gaporder1.json").read_text()
        return JaxQuaffParams.from_json(text), QuaffParams.from_json(text)
    return jax_default_params(), default_params()


@pytest.mark.parametrize("kind", ["default", "gaporder1"])
def test_score_tables_match_reference(kind, data_dir):
    jp, qp = _params(kind, data_dir)
    mine = ScoreTables.from_params(qp)
    ref = JaxScoreTables.from_params(jp)
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
    jt = JaxScoreTables.from_params(jax_default_params())
    pairs = _synthetic_multistrip(rng, 3) + _random_pairs(rng, 2)
    if packed:
        mine = engine.PairBatch.build_packed(port_pairs(pairs), tt)
        ref = jax_engine.PairBatch.build_packed(pairs, jt)
    else:
        mine = engine.PairBatch.build(port_pairs(pairs), tt, width=300,
                                      max_y_len=200)
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
    jp, qp = _params(kind, data_dir)
    tt, jt = ScoreTables.from_params(qp), JaxScoreTables.from_params(jp)
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
        engine.to_device(engine.PairBatch.build(port_pairs(pairs), tt), "cpu"),
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
    from quaff_tpu.envelope import make_envelope as jax_make_envelope
    from quaff_tpu.io.fastseq import KmerIndex as JaxKmerIndex
    from quaff_tpu.io.fastseq import read_fast_seqs as jax_read_fast_seqs
    from quaff_tpu_torch.envelope import make_envelope
    from quaff_tpu_torch.io.fastseq import KmerIndex, read_fast_seqs

    def c8f30(read, index, envelope):
        y = read(str(data_dir / "c8f30.fastq.gz"))[0]
        x = read(str(data_dir / "c8f30.fastq.gz"))[0]
        x.qual = ""
        return [(x, y, envelope(x, index(y, 6), kmer_threshold=-1,
                                cell_size=24, max_size=10 << 20))]

    tt = ScoreTables.from_params(default_params())
    jt = JaxScoreTables.from_params(jax_default_params())
    got = engine.dp_fill(
        engine.table_tensors(tt),
        engine.to_device(engine.PairBatch.build(
            c8f30(read_fast_seqs, KmerIndex, make_envelope), tt), "cpu"),
    )["score"].numpy()
    ref = np.asarray(jax_engine.dp_fill(
        jax_engine.device_tables(jt),
        jax_engine.device_batch(jax_engine.PairBatch.build(
            c8f30(jax_read_fast_seqs, JaxKmerIndex, jax_make_envelope), jt)),
        dtype=jnp.float64,
    )["score"])
    np.testing.assert_array_equal(got, ref)


def test_dp_fill_rejects_packed():
    rng = np.random.default_rng(25)
    tt = ScoreTables.from_params(default_params())
    pb = engine.PairBatch.build_packed(port_pairs(_synthetic_multistrip(rng, 2)),
                                       tt)
    with pytest.raises(ValueError, match="packed"):
        engine.dp_fill(engine.table_tensors(tt), engine.to_device(pb, "cpu"))
