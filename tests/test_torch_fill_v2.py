"""K1 in the PyTorch port (quaff_tpu_torch/dp/fill_v2.py) against the JAX
package: the plain PyTorch version behind `scores_v2` must match the
Pallas kernel run in interpret mode on the same packed batches, and the
JAX float32 engine on single-window batches.  Both sides get identical
tables (tables_from_reference) and inputs made from a numpy seed.

Tolerance: the JAX kernel's own, rtol 1e-5 / atol 1e-3
(tests/test_pallas_v2.py): float32 sums taken in another order.

The CUDA kernel itself runs only on the card: tests/test_torch_kernel_cuda.py
and chip_smoke.py hold it against this plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quaff_tpu.dp.engine import PairBatch as JaxPairBatch
from quaff_tpu.dp.engine import device_batch, device_tables
from quaff_tpu.dp.engine import dp_fill as jax_dp_fill
from quaff_tpu.dp.pallas_v2 import V2Tables as JaxV2Tables
from quaff_tpu.dp.pallas_v2 import scores_v2_traceable
from quaff_tpu.dp.scores import ScoreTables as JaxScoreTables
from quaff_tpu.envelope import full_envelope, pack_strips
from quaff_tpu.model.params import QuaffParams, default_params
from quaff_tpu_torch.dp import fill_v2
from quaff_tpu_torch.dp.engine import PairBatch, dp_fill, table_tensors, to_device
from quaff_tpu_torch.dp.scores import ScoreTables
from quaff_tpu_torch.envelope import pack_strips as port_pack_strips
from test_pallas_v2 import _random_pairs
from test_strips import _synthetic_multistrip
from test_torch_engine import port_pairs, port_params

RTOL, ATOL = 1e-5, 1e-3


def _close(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=ATOL)


def _tables(params):
    """(JAX tables, port tables, port V2Tables fed the JAX arrays) of the
    JAX package's params; the port's tables come from its own params."""
    jt = JaxScoreTables.from_params(params)
    arrays = {k: np.asarray(v) for k, v in device_tables(jt).items()}
    return (jt, ScoreTables.from_params(port_params(params)),
            fill_v2.tables_from_reference(arrays))


def _order2_gap1_params():
    """Match order 2 (16 contexts) with gap order 1, the JAX test's
    construction (tests/test_pallas_v2.py)."""
    qp = default_params()
    qp2 = QuaffParams.create(2, 1)
    qp2.ref_base = qp.ref_base
    qp2.extend_insert, qp2.extend_delete = qp.extend_insert, qp.extend_delete
    qp2.begin_insert[:] = qp.begin_insert[0]
    qp2.begin_delete[:] = qp.begin_delete[0]
    qp2.insert_prob, qp2.insert_q, qp2.insert_r = (
        qp.insert_prob, qp.insert_q, qp.insert_r
    )
    for j in range(16):
        qp2.match_prob[:, j] = qp.match_prob[:, j % 4]
        qp2.match_q[:, j] = qp.match_q[:, j % 4]
        qp2.match_r[:, j] = qp.match_r[:, j % 4]
    return qp2


def _gaporder1_params(data_dir):
    """beginInsert/beginDelete spread over the 4 indel contexts, so the
    per-row transitions really vary."""
    return QuaffParams.from_json((data_dir / "params-gaporder1.json").read_text())


@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("local", [True, False])
def test_packed_matches_interpret_kernel(mode, local):
    """Lane-packed multi-strip batch, pair scores and (Viterbi) per-strip
    end maxima, against scores_v2_traceable(interpret=True)."""
    rng = np.random.default_rng(21)
    jt, tt, v2 = _tables(default_params())
    pairs = _synthetic_multistrip(rng, 4)
    assert any(len(pack_strips(e, 3)) >= 2 for _, _, e in pairs)
    segs = mode == "viterbi"
    ref = np.asarray(scores_v2_traceable(
        JaxV2Tables(jt), device_batch(JaxPairBatch.build_packed(pairs, jt)),
        mode=mode, local=local, interpret=True, return_segments=segs,
    ))
    pb = PairBatch.build_packed(port_pairs(pairs), tt)
    got = fill_v2.scores_v2(
        v2, to_device(pb, "cpu"), mode=mode, local=local,
        return_segments=segs, max_prop=fill_v2.batch_max_prop(pb),
    )
    if segs:
        got = np.concatenate([got[0], got[1].ravel()])
    _close(got, ref)


@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("local", [True, False])
def test_window_matches_f32_engine(mode, local):
    """Single-window batches (one full envelope among sparse ones) against
    the JAX float32 XLA engine, as tests/test_pallas_v2.py holds the
    Pallas kernel."""
    rng = np.random.default_rng(3)
    jt, tt, v2 = _tables(default_params())
    pairs = _random_pairs(rng, 6)
    pairs[5] = (pairs[5][0], pairs[5][1],
                full_envelope(len(pairs[5][0].seq), len(pairs[5][1].seq)))
    ref = np.asarray(jax_dp_fill(
        device_tables(jt), device_batch(JaxPairBatch.build(pairs, jt)),
        mode=mode, local=local, return_matrices=False, dtype=jnp.float32,
    )["score"])
    got = fill_v2.scores_v2(
        v2, to_device(PairBatch.build(port_pairs(pairs), tt), "cpu"),
        mode=mode, local=local,
    )
    _close(got, ref)


@pytest.mark.parametrize("params", ["order2_gap1", "gaporder1"])
@pytest.mark.parametrize("with_qual", [False, True])
def test_kmer_contexts_and_noqual(params, with_qual, data_dir):
    """Per-row indel contexts (n_ik > 1), order-2 match contexts and reads
    without qualities, against the interpret-mode kernel and the JAX
    float32 engine."""
    qp = _order2_gap1_params() if params == "order2_gap1" else _gaporder1_params(data_dir)
    rng = np.random.default_rng(11)
    jt, tt, v2 = _tables(qp)
    assert v2.n_ik == 4
    pairs = _random_pairs(rng, 3, with_qual=with_qual)
    got = fill_v2.scores_v2(
        v2, to_device(PairBatch.build_packed(port_pairs(pairs), tt), "cpu"),
        mode="viterbi", local=True,
    )
    ref_kernel = np.asarray(scores_v2_traceable(
        JaxV2Tables(jt, has_qual=with_qual),
        device_batch(JaxPairBatch.build_packed(pairs, jt)),
        mode="viterbi", local=True, interpret=True,
    ))
    ref_engine = np.asarray(jax_dp_fill(
        device_tables(jt), device_batch(JaxPairBatch.build(pairs, jt)),
        mode="viterbi", local=True, return_matrices=False, dtype=jnp.float32,
    )["score"])
    _close(got, ref_kernel)
    _close(got, ref_engine)


def test_segment_scores_match_strip_fills():
    """return_segments: each strip's end maximum equals an independent
    float64 fill of that strip (pack_strips order), the pair score is the
    max over strips, and absent strips are -inf."""
    rng = np.random.default_rng(27)
    _, tt, v2 = _tables(default_params())
    pairs = port_pairs(_synthetic_multistrip(rng, 4))
    pb = PairBatch.build_packed(pairs, tt)
    scores, segmax = fill_v2.scores_v2(
        v2, to_device(pb, "cpu"), mode="viterbi", local=True,
        return_segments=True,
    )
    tabs = table_tensors(tt)
    for b, (x, y, env) in enumerate(pairs):
        strips = port_pack_strips(env, 3)
        per_strip = dp_fill(
            tabs, to_device(PairBatch.build([(x, y, s) for s in strips], tt), "cpu"),
            mode="viterbi", local=True,
        )["score"].numpy()
        _close(segmax[b, : len(strips)], per_strip)
        assert np.all(np.isneginf(segmax[b, len(strips):]))
        _close(scores[b], per_strip.max())


def test_max_prop_does_not_change_scores():
    """Bounding the delete-scan reach at the widest strip (pow2) changes no
    score: halo lanes already stop the chain at strip seams."""
    rng = np.random.default_rng(29)
    _, tt, v2 = _tables(default_params())
    pb = PairBatch.build_packed(port_pairs(_synthetic_multistrip(rng, 4)), tt)
    mp = fill_v2.batch_max_prop(pb)
    assert mp is not None and mp < pb.member.shape[1]
    for mode in ("viterbi", "forward"):
        full = fill_v2.scores_v2(v2, to_device(pb, "cpu"), mode=mode)
        capped = fill_v2.scores_v2(v2, to_device(pb, "cpu"), mode=mode,
                                   max_prop=mp)
        np.testing.assert_array_equal(capped, full)


@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("local", [True, False])
def test_plain_float64_witness(mode, local):
    """band_fill_reference with dtype float64 (chip_smoke.py's witness of
    float32 drift) is the float64 engine's fill on the float32 tables'
    values, to rounding; its float32 run agrees with it within K1's
    tolerance."""
    rng = np.random.default_rng(31)
    _, tt, _ = _tables(default_params())
    v2 = fill_v2.V2Tables.from_tables(tt)
    tabs = {k: v.float().double() for k, v in table_tensors(tt).items()}
    bdev = to_device(PairBatch.build(port_pairs(_random_pairs(rng, 5)), tt),
                     "cpu")
    inp = fill_v2.kernel_inputs(bdev)
    B = inp["doff"].shape[0]
    wit = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode,
                                      local=local, dtype=torch.float64)
    assert wit.dtype == torch.float64
    ref = dp_fill(tabs, bdev, mode=mode, local=local)["score"].numpy()
    # no path: the engine's -inf, the fill's float32-minimum floor
    got = wit[:B].numpy()
    got = np.where(got <= fill_v2.NEG_INF / 2, -np.inf, got)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-9, atol=1e-9)
    f32 = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode,
                                      local=local)
    assert f32.dtype == torch.float32
    _close(f32, wit)


def test_tables_from_reference_match_port_tables():
    jt, tt, v2 = _tables(_order2_gap1_params())
    mine = fill_v2.V2Tables.from_tables(tt)
    for name in ("match", "match_noq", "insert", "insert_noq", "ik", "trans"):
        torch.testing.assert_close(getattr(mine, name), getattr(v2, name),
                                   rtol=0, atol=0)
    assert tuple(v2.match.shape) == (4, 16, 94)
    assert tuple(v2.ik.shape) == (4, 4)


def test_band_fill_routes_by_device():
    """CPU tensors take the plain version and launch nothing; a device
    with no kernel raises instead of falling back."""
    rng = np.random.default_rng(5)
    _, tt, v2 = _tables(default_params())
    inp = fill_v2.kernel_inputs(to_device(
        PairBatch.build_packed(port_pairs(_random_pairs(rng, 2)), tt), "cpu"))
    before = fill_v2.band_fill.launches
    out = fill_v2.band_fill(**inp, tables=v2)
    assert fill_v2.band_fill.launches == before
    B, S = inp["seg_start"].shape
    assert out.shape == (B + B * S,) and out.dtype == torch.float32
    meta_inp = {k: v.to("meta") for k, v in inp.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        fill_v2.band_fill(**meta_inp, tables=v2)


@pytest.mark.parametrize("W, route", [
    (1, ("warp", 1)), (32, ("warp", 1)), (33, ("warp", 2)),
    (203, ("warp", 8)), (256, ("warp", 8)), (512, ("warp", 16)),
    (513, ("cluster", (1, 5, 4))), (2048, ("cluster", (1, 16, 4))),
    (2049, ("cluster", (1, 9, 8))), (4038, ("cluster", (1, 16, 8))),
    (8192, ("cluster", (2, 16, 8))), (16384, ("cluster", (8, 4, 16))),
    (16385, ("block", 0)),
])
def test_fill_route_and_cpu_plain(W, route):
    """K1's route is a pure function of the band's width: the warp route
    with the smallest lanes-a-thread whose warp covers the band, up to
    32 * 16 lanes; the cluster route past it, its tiling (CTAs a pair,
    warps a CTA, lanes a thread) from FILL_CLUSTER_TABLE, up to
    FILL_CLUSTER_MAX_LANES; the block route past that.  A CPU tensor of any
    width takes the plain version and moves no launch count."""
    from test_torch_kernel_cuda import random_fill_inputs

    assert fill_v2.fill_route(W) == route
    assert 32 * fill_v2.WARP_LPTS[-1] == 512
    _, tt, _ = _tables(default_params())
    inp, v2 = random_fill_inputs(np.random.default_rng(W), tt, W, B=2,
                                 Lx=60, Ly=24, device="cpu")
    counts = ("launches", "warp_launches", "cluster_launches",
              "block_launches")
    before = [getattr(fill_v2.band_fill, k) for k in counts]
    out = fill_v2.band_fill(**inp, tables=v2)
    assert [getattr(fill_v2.band_fill, k) for k in counts] == before
    assert torch.equal(out, fill_v2.band_fill_reference(**inp, tables=v2))


def test_fill_cluster_tilings_cover_their_bands():
    """Every width the cluster route takes gets a tiling the kernel has:
    lanes a thread of FILL_CLUSTER_LPTS, at most MAX_TILES tiles, at most
    MAX_CLUSTER_CTAS CTAs of at most fill_cluster_max_warps warps, covering
    the band, with no whole tile past it; the tiling never narrows as the
    band widens within one table row."""
    lo = 32 * fill_v2.WARP_LPTS[-1] + 1
    prev = None
    for W in range(lo, fill_v2.FILL_CLUSTER_MAX_LANES + 1):
        kind, (nct, warps, lpt) = fill_v2.fill_route(W)
        assert kind == "cluster"
        assert lpt in fill_v2.FILL_CLUSTER_LPTS
        assert nct <= fill_v2.MAX_CLUSTER_CTAS
        assert warps <= fill_v2.fill_cluster_max_warps(lpt)
        assert nct * warps <= fill_v2.MAX_TILES
        tiles = -(-W // (32 * lpt))
        assert nct * warps >= tiles and (nct - 1) * warps < tiles
        if prev is not None and prev[2] == lpt:
            assert nct * warps >= prev[0] * prev[1]
        prev = (nct, warps, lpt)


@pytest.mark.parametrize("route, ok", [
    (("warp", 16), False), (("cluster", (1, 5, 4)), True),
    (("cluster", (1, 4, 4)), False), (("cluster", (2, 3, 4)), True),
    (("cluster", (1, 17, 4)), False), (("cluster", (1, 9, 16)), False),
    (("cluster", (8, 1, 4)), True), (("cluster", (16, 1, 4)), False),
    (("cluster", (1, 5, 2)), False), (("cluster", (1, 5)), False),
    (("block", 0), True), (("block", None), False), (("tile", 0), False),
])
def test_band_fill_forced_route(route, ok):
    """A route given to band_fill must be one K1 has and cover the band
    (here 513 lanes) in a cluster of at most MAX_CLUSTER_CTAS (8) CTAs, or
    band_fill raises ValueError before any launch.  On CPU tensors every route runs the plain
    version and moves no launch count, cluster_launches included."""
    from test_torch_kernel_cuda import random_fill_inputs

    _, tt, _ = _tables(default_params())
    inp, v2 = random_fill_inputs(np.random.default_rng(2), tt, 513, B=2,
                                 Lx=60, Ly=24, device="cpu")
    counts = ("launches", "warp_launches", "cluster_launches",
              "block_launches")
    before = [getattr(fill_v2.band_fill, k) for k in counts]
    if ok:
        out = fill_v2.band_fill(**inp, tables=v2, route=route)
        assert torch.equal(out, fill_v2.band_fill_reference(**inp,
                                                            tables=v2))
    else:
        with pytest.raises(ValueError, match="no route"):
            fill_v2.band_fill(**inp, tables=v2, route=route)
    assert [getattr(fill_v2.band_fill, k) for k in counts] == before
