"""The port's exact counting engine (quaff_tpu_torch/dp/counts.py) against
the JAX package's float64 dp_forward_backward, and the counting goldens.

Both sides get the same seeded pairs (tests/test_pallas_counts.py's
generator), each building its own batch; scores, counts and posterior
matrices must agree to rtol 1e-9 / atol 1e-9 in float64 (the two
libraries round log-add-exp in the last bits differently).
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quaff_tpu.dp.counts import dp_forward_backward as jax_forward_backward
from quaff_tpu.dp.engine import PairBatch as JaxPairBatch
from quaff_tpu.dp.engine import device_batch, device_tables
from quaff_tpu.dp.scores import ScoreTables as JaxScoreTables
from quaff_tpu.model.params import QuaffNullParams as JaxQuaffNullParams
from quaff_tpu.model.params import QuaffParamCounts as JaxQuaffParamCounts
from quaff_tpu.model.params import QuaffParams as JaxQuaffParams
from quaff_tpu.model.params import default_params as jax_default_params
from quaff_tpu_torch.aligner import DPConfig
from quaff_tpu_torch.dp.counts import dp_forward_backward
from quaff_tpu_torch.dp.engine import PairBatch, table_tensors, to_device
from quaff_tpu_torch.dp.scores import ScoreTables
from quaff_tpu_torch.io.fastseq import read_fast_seqs
from quaff_tpu_torch.model.params import (
    QuaffNullParams,
    QuaffParams,
    default_params,
)
from quaff_tpu_torch.trainer import QuaffCounter
from test_pallas_counts import _pairs
from test_torch_engine import port_pairs


def _gap1_params(jax_pairs):
    """Match order 1, gap order 1, fitted from the null model of the reads
    (tests/test_pallas_counts.py's construction)."""
    null = JaxQuaffNullParams.fit([y for _, y, _ in jax_pairs])
    pc = JaxQuaffParamCounts.zero(1, 1)
    pc.init_counts(9, 9, 5, 1, null)
    return pc.fit()


def _both(jax_params, jax_pairs, local, return_post, dtype=torch.float64):
    """Both engines on the same pairs and params: each side reads the
    params from the same JSON text (a JSON round trip rounds them)."""
    text = io.StringIO()
    jax_params.write_json(text)
    jax_params = JaxQuaffParams.from_json(text.getvalue())
    jt = JaxScoreTables.from_params(jax_params)
    ref = jax_forward_backward(
        device_tables(jt), device_batch(JaxPairBatch.build(jax_pairs, jt)),
        local=local, dtype=jnp.float64,
        num_match_kmers=jax_params.num_match_kmers,
        num_indel_kmers=jax_params.num_indel_kmers, return_post=return_post,
    )
    qp = QuaffParams.from_json(text.getvalue())
    tt = ScoreTables.from_params(qp)
    got = dp_forward_backward(
        table_tensors(tt), to_device(PairBatch.build(port_pairs(jax_pairs), tt),
                                     "cpu"),
        local=local, dtype=dtype, num_match_kmers=qp.num_match_kmers,
        num_indel_kmers=qp.num_indel_kmers, return_post=return_post,
    )
    return ({k: np.asarray(v, np.float64) for k, v in ref.items()},
            {k: v.double().numpy() for k, v in got.items()})


@pytest.mark.parametrize("gap_order", [0, 1])
@pytest.mark.parametrize("local", [True, False])
def test_f64_matches_jax_engine(gap_order, local):
    rng = np.random.default_rng(9)
    pairs = _pairs(rng, 4)
    jp = jax_default_params() if gap_order == 0 else _gap1_params(pairs)
    ref, got = _both(jp, pairs, local, return_post=True)
    assert set(got) == set(ref)
    for k in ref:
        a, g = ref[k], got[k]
        assert a.shape == g.shape, k
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(a),
                                      err_msg=k)
        fin = np.isfinite(a)
        np.testing.assert_allclose(g[fin], a[fin], rtol=1e-9, atol=1e-9,
                                   err_msg=k)
    if local:
        assert np.isfinite(ref["fwd_score"]).all()
        assert ref["match_counts"].sum() > 0


def _c8f30(data_dir):
    reads = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    refs = read_fast_seqs(str(data_dir / "c8f30.fastq.gz"))
    for r in refs:
        r.qual = ""
    return refs, reads


def test_c8f30_self_counts_golden(data_dir):
    """tests/test_count_golden.py's reference integration test, through the
    port's counter on the host in float64: byte for byte."""
    refs, reads = _c8f30(data_dir)
    counter = QuaffCounter(default_params(), QuaffNullParams.fit(reads),
                           DPConfig(kmer_threshold=-1, max_size=10 << 20,
                                    device="cpu"))
    counts, _, orders = counter.get_counts(refs, reads)
    assert orders == [[0]]
    out = io.StringIO()
    counts.write_json(out)
    golden = (data_dir / "c8f30-self-counts.json").read_text()
    assert out.getvalue() == golden.rstrip("\n")


def test_fwd_back_consistency(data_dir):
    """The backward score equals the forward score within the reference's
    own tolerance (MAX_FRACTIONAL_FWDBACK_ERROR, qmodel.cpp:20)."""
    from quaff_tpu_torch.envelope import make_envelope
    from quaff_tpu_torch.io.fastseq import KmerIndex

    refs, reads = _c8f30(data_dir)
    y = reads[0]
    env = make_envelope(refs[0], KmerIndex(y, 6), kmer_threshold=-1,
                        cell_size=48, max_size=10 << 20)
    tt = ScoreTables.from_params(default_params())
    res = dp_forward_backward(
        table_tensors(tt),
        to_device(PairBatch.build([(refs[0], y, env)], tt), "cpu"),
    )
    fwd, back = float(res["fwd_score"][0]), float(res["back_score"][0])
    assert abs(fwd - back) <= 1e-4 * abs(fwd)


def test_postmatrix_row_identity(capsys):
    """Each read row emits exactly one base: the row sums of postMatch +
    postInsert are 1 for a lone ref; the `-log postmatrix` dump of those
    posteriors is the JAX package's, byte for byte."""
    from quaff_tpu.dp.debug import write_post_matrix as jax_write_post_matrix
    from quaff_tpu.envelope import full_envelope
    from quaff_tpu.io.fastseq import FastSeq as JaxFastSeq
    from quaff_tpu_torch.dp.debug import write_post_matrix

    rng = np.random.default_rng(3)
    xs = "".join("ACGT"[t] for t in rng.integers(0, 4, 60))
    ys = xs[10:50]
    x = JaxFastSeq(name="x", seq=xs)
    y = JaxFastSeq(name="y", seq=ys, qual="".join(
        chr(33 + int(q)) for q in rng.integers(5, 30, len(ys))))
    jax_pairs = [(x, y, full_envelope(len(xs), len(ys)))]
    ref, got = _both(jax_default_params(), jax_pairs, True, return_post=True)
    pm, pi, pd = (got[k][0] for k in ("post_mat", "post_ins", "post_del"))
    np.testing.assert_allclose((pm + pi).sum(axis=1)[: len(ys)], 1.0,
                               rtol=1e-9)

    px, py, penv = port_pairs(jax_pairs)[0]
    mine = io.StringIO()
    write_post_matrix(px, py, penv, pm, pi, pd, out=mine)
    want = io.StringIO()
    jax_write_post_matrix(x, y, jax_pairs[0][2], ref["post_mat"][0],
                          ref["post_ins"][0], ref["post_del"][0], out=want)
    assert mine.getvalue() == want.getvalue()
    assert mine.getvalue().startswith("i=1:")
    write_post_matrix(px, py, penv, pm, pi, pd)
    assert capsys.readouterr().err == mine.getvalue()  # stderr by default


def test_f32_engine_is_close():
    """The float32 engine (`count -fast` off the card) on short reads stays
    within the count tolerance of float64."""
    rng = np.random.default_rng(13)
    pairs = _pairs(rng, 3)
    _, f64 = _both(jax_default_params(), pairs, True, False)
    _, f32 = _both(jax_default_params(), pairs, True, False, torch.float32)
    for k in ("fwd_score", "match_counts", "insert_counts", "m2m", "d2d"):
        np.testing.assert_allclose(f32[k], f64[k], rtol=3e-3, atol=5e-3,
                                   err_msg=k)
