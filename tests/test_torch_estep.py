"""K2 and K3 in the port (quaff_tpu_torch/dp/estep.py), through their plain
PyTorch versions, against the JAX package's Pallas E-step run in interpret
mode on the same pairs (each side builds its own lane-packed batch; the
port's tables are fed the JAX arrays).

Tolerances, the JAX kernels' own (tests/test_pallas_counts.py): forward
scores and y_ll rtol 1e-5 / atol 1e-3; counts rtol 3e-3 / atol 5e-3.
The CUDA kernels run only on the card: tests/test_torch_kernel_cuda.py and
chip_smoke.py hold them against these plain versions there.
"""

import pathlib

import numpy as np
import pytest
import torch

from quaff_tpu.dp.engine import PairBatch as JaxPairBatch
from quaff_tpu.dp.engine import device_batch, device_tables
from quaff_tpu.dp.pallas_counts import estep_fused_multi as jax_fused_multi
from quaff_tpu.dp.pallas_counts import estep_kernel as jax_estep_kernel
from quaff_tpu.dp.pallas_v2 import V2Tables as JaxV2Tables
from quaff_tpu.dp.scores import ScoreTables as JaxScoreTables
from quaff_tpu.model.params import default_params as jax_default_params
from quaff_tpu_torch.dp import estep, fill_v2
from quaff_tpu_torch.dp.engine import PairBatch, to_device
from quaff_tpu_torch.dp.scores import ScoreTables
from test_pallas_counts import _pairs
from test_torch_counts import _gap1_params
from test_torch_engine import port_pairs, port_params

FWD = dict(rtol=1e-5, atol=1e-3)
COUNTS = dict(rtol=3e-3, atol=5e-3)


def _sides(jax_params, jax_pairs):
    """(JAX tables, JAX V2 tables, JAX device batch, port V2 tables fed the
    JAX arrays, port batch on the CPU)."""
    jt = JaxScoreTables.from_params(jax_params)
    tt = ScoreTables.from_params(port_params(jax_params))
    v2 = fill_v2.tables_from_reference(
        {k: np.asarray(v) for k, v in device_tables(jt).items()})
    bdev = device_batch(JaxPairBatch.build_packed(jax_pairs, jt))
    pb = to_device(PairBatch.build_packed(port_pairs(jax_pairs), tt), "cpu")
    return jt, JaxV2Tables(jt), bdev, v2, pb


def _counts_close(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        a = np.asarray(ref[k], np.float64)
        assert got[k].shape == a.shape, k
        np.testing.assert_allclose(got[k], a, err_msg=k, **COUNTS)


@pytest.mark.parametrize("gap_order", [0, 1])
def test_fused_multi_matches_interpret_kernel(gap_order):
    """Pairs of two reads in one batch: per-group y_ll, pair weights
    exp(fwd - y_ll[gid]) and the batch's summed counts."""
    rng = np.random.default_rng(31)
    pairs = _pairs(rng, 6)
    jp = jax_default_params() if gap_order == 0 else _gap1_params(pairs)
    jt, jv2, bdev, v2, pb = _sides(jp, pairs)
    gid = np.array([0, 0, 0, 1, 1, 1], np.int32)
    fwd0 = estep.estep_fused_multi(v2, pb, gid, np.array([-np.inf] * 2))[0]
    null_lls = np.array([fwd0[:3].max(), fwd0[3:].max() - 1.0])
    jf, jy, jc = jax_fused_multi(jt, jv2, bdev, gid, null_lls, interpret=True)
    before = estep.fwd_store.launches, estep.bwd_counts.launches
    f, y, c = estep.estep_fused_multi(v2, pb, gid, null_lls)
    assert (estep.fwd_store.launches, estep.bwd_counts.launches) == before
    np.testing.assert_allclose(f, np.asarray(jf), **FWD)
    np.testing.assert_allclose(y, np.asarray(jy), **FWD)
    _counts_close(c, jc)
    assert v2.n_ik == (1 if gap_order == 0 else 4)


def test_fused_single_read_and_caller_weights():
    """estep_fused (one read group) and estep_kernel (weights and
    normalisers from the caller) against their JAX counterparts."""
    from quaff_tpu.dp.pallas_counts import estep_fused as jax_fused

    rng = np.random.default_rng(11)
    pairs = _pairs(rng, 4)
    jt, jv2, bdev, v2, pb = _sides(jax_default_params(), pairs)
    jf, jy, jc = jax_fused(jt, jv2, bdev, -300.0, interpret=True)
    f, y, c = estep.estep_fused(v2, pb, -300.0)
    np.testing.assert_allclose(f, np.asarray(jf), **FWD)
    np.testing.assert_allclose(y, np.asarray(jy).reshape(-1), **FWD)
    _counts_close(c, jc)

    weights = np.array([1.0, 0.5, 2.0, 0.25])
    jf, jc = jax_estep_kernel(jt, jv2, bdev, weights, np.asarray(jf),
                              interpret=True)
    f, c = estep.estep_kernel(v2, pb, weights, f)
    np.testing.assert_allclose(f, np.asarray(jf), **FWD)
    _counts_close(c, jc)
    # each pair's back-start posterior exp(back - fwd) is 1
    np.testing.assert_allclose(c["back_start_post"], 1.0, rtol=5e-3)


def test_scaled_fill_keeps_the_forward_fill():
    """K2's plain version keeps the Forward fill scaled: each stored row's
    largest cell is 0, its offset carries the rest, and the pair scores
    agree with K1's unscaled Forward fill."""
    rng = np.random.default_rng(5)
    tt = ScoreTables.from_params(port_params(jax_default_params()))
    v2 = fill_v2.V2Tables.from_tables(tt)
    inp = fill_v2.kernel_inputs(
        to_device(PairBatch.build_packed(port_pairs(_pairs(rng, 3)), tt), "cpu"))
    B, W = inp["doff"].shape
    Ly = inp["keys"].shape[1]
    plain = torch.full((3, B, Ly, W), fill_v2.NEG_INF)
    offsets = torch.zeros((B, Ly), dtype=torch.float64)
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode="forward",
                                      rows=plain, offsets=offsets)
    unscaled = fill_v2.band_fill_reference(**inp, tables=v2, mode="forward")
    np.testing.assert_allclose(ref[:B], unscaled[:B], **FWD)
    fwd, rows, offs = estep.fwd_store(**inp, tables=v2)
    assert torch.equal(fwd, ref[:B]) and torch.equal(offs, offsets)
    live = rows > fill_v2.NEG_INF / 2
    top = torch.where(live, rows, float("-inf")).amax(dim=(0, 3))  # [B, Ly]
    ylen = inp["meta"][:, 1]
    for b in range(B):
        assert bool((top[b, : ylen[b]] == 0).all())
        assert float(offs[b, ylen[b] - 1]) < -50.0


def _reduce_emulated(part: np.ndarray) -> np.ndarray:
    """The count reduction's order in numpy float32: rows b, b+G, b+2G, ...
    into accumulator b % G, then ((0+1)+(2+3))+((4+5)+(6+7))."""
    G = estep.REDUCE_WARPS
    acc = np.zeros((G, part.shape[1]), np.float32)
    for b in range(part.shape[0]):
        acc[b % G] = acc[b % G] + part[b]
    while len(acc) > 1:
        acc = acc[0::2] + acc[1::2]
    return acc[0]


@pytest.mark.parametrize("E", [1, 31, 33, 1884])
@pytest.mark.parametrize("B", [1, 7, 8, 9, 256, 257])
def test_reduce_reference_order(B, E):
    """The plain count reduction (the CUDA kernel's order step by step)
    equals a numpy float32 emulation of that order bit for bit, ragged row
    groups and column tiles included."""
    rng = np.random.default_rng(B * 10007 + E)
    part = (rng.random((B, E), dtype=np.float32)
            * rng.choice([1e-3, 1.0, 1e3], (B, 1)).astype(np.float32))
    got = estep.estep_reduce_reference(torch.from_numpy(part))
    assert got.dtype == torch.float32 and got.shape == (E,)
    np.testing.assert_array_equal(got.numpy(), _reduce_emulated(part))


def test_reduce_reference_near_float64():
    """The fixed order loses no more than float32 rounding: within 1e-6
    relative of the float64 sum of nonnegative counts."""
    rng = np.random.default_rng(11)
    part = rng.random((257, 1884), dtype=np.float32)
    got = estep.estep_reduce_reference(torch.from_numpy(part)).double()
    want = torch.from_numpy(part.astype(np.float64).sum(0))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions; a device without a kernel
    raises instead of falling back."""
    rng = np.random.default_rng(7)
    tt = ScoreTables.from_params(port_params(jax_default_params()))
    v2 = fill_v2.V2Tables.from_tables(tt)
    inp = fill_v2.kernel_inputs(
        to_device(PairBatch.build_packed(port_pairs(_pairs(rng, 2)), tt), "cpu"))
    fwd, rows, offs = estep.fwd_store(**inp, tables=v2)
    wrow = torch.stack([torch.ones_like(fwd), fwd]).contiguous()
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
            rows, offs)
    part, sc = estep.bwd_counts(*base)
    assert part.shape == (2, estep.table_size(v2)) and sc.shape == (5, 2)
    torch.testing.assert_close(estep.estep_reduce(part), part.sum(0))
    meta = {k: v.to("meta") for k, v in inp.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        estep.fwd_store(**meta, tables=v2)
    with pytest.raises(RuntimeError, match="no kernel"):
        estep.bwd_counts(*(t.to("meta") for t in base[:4]), v2,
                         *(t.to("meta") for t in base[5:]))
    with pytest.raises(RuntimeError, match="no kernel"):
        estep.estep_reduce(part.to("meta"))


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
@pytest.mark.parametrize("lpt", [1, 2, 4, 8, 16, None])
def test_estep_route_table(kernel, lpt):
    """K2's and K3's routes are a pure function of the band's width: every
    width up to the kernel's ESTEP_WARP_MAX_LANES takes the warp route
    with the smallest lanes-a-thread whose warp (32 * lpt lanes) covers it
    (the widths 16*lpt+1 .. 32*lpt), every wider band the block route (lpt
    None: the widths past the cutover)."""
    cut = estep.ESTEP_WARP_MAX_LANES[kernel]
    assert cut in (256, 512)
    if lpt is None:
        widths = range(cut + 1, cut + 4097)
    else:
        widths = range(16 * lpt + 1 if lpt > 1 else 1, 32 * lpt + 1)
    want = ("warp", lpt) if lpt is not None and 32 * lpt <= cut else \
        ("block", 0)
    assert all(estep.estep_route(W, kernel) == want for W in widths)


@pytest.mark.parametrize("W,lpt", [(1, 1), (32, 1), (33, 2), (64, 2),
                                   (65, 4), (128, 4), (129, 8), (256, 8),
                                   (257, 16), (512, 16), (513, None),
                                   (12070, None)])
def test_warp_lpt(W, lpt):
    """The warp routes' lanes a thread: the smallest of 1/2/4/8/16 whose
    warp covers the band, none past 512 lanes; estep_route takes it up to
    each kernel's cutover."""
    assert estep.warp_lpt(W) == lpt
    for kernel, cut in estep.ESTEP_WARP_MAX_LANES.items():
        want = ("warp", lpt) if W <= cut else ("block", 0)
        assert estep.estep_route(W, kernel) == want


def test_estep_card_variants_cover_both_table_homes():
    """K3's warp route keeps a pair's count table in shared memory while a
    block's kWarpsPerBlock tables fit kTableSmemBytes, else in partial
    itself: the card tests' variants take both (sub2's -suborder 2 table
    is past the limit, the order-1 tables within it)."""
    import re

    from quaff_tpu_torch import kernels
    from test_torch_kernel_cuda import ESTEP_VARIANTS, _tables

    csrc = pathlib.Path(kernels.__file__).parent / "csrc"
    warps = int(re.search(r"kWarpsPerBlock = (\d+);", (
        csrc / "band_fill_warp.cuh").read_text()).group(1))
    limit = 1024 * int(re.search(r"kTableSmemBytes = (\d+) \* 1024;", (
        csrc / "estep_warp.cuh").read_text()).group(1))
    in_smem = {name: warps * 4 * estep.table_size(fill_v2.V2Tables.from_tables(
                   _tables(case), "cpu")) <= limit
               for name, (_, case) in ESTEP_VARIANTS.items()}
    assert in_smem == {"local": True, "local-gap1": True, "global": True,
                       "global-gap1": True, "local-sub2": False}


def test_estep_forced_route_on_cpu():
    """A route given to fwd_store or bwd_counts must cover the band; on CPU
    tensors every route runs the plain version and moves no launch
    count."""
    from test_torch_kernel_cuda import _tables, random_fill_inputs

    inp, v2 = random_fill_inputs(np.random.default_rng(3), _tables("packed"),
                                 40, B=2, Lx=60, Ly=24, device="cpu")
    fwd, rows, offs = estep.fwd_store_reference(**inp, tables=v2)
    wrow = torch.stack([torch.ones_like(fwd), torch.where(
        fwd > fill_v2.NEG_INF / 2, fwd, 0.0)]).contiguous()
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
            rows, offs)
    part, sc = estep.bwd_counts_reference(*base)
    counts = ("launches", "warp_launches", "block_launches")
    before = {f: [getattr(getattr(estep, f), k) for k in counts]
              for f in ("fwd_store", "bwd_counts")}
    for route in (None, ("warp", 2), ("warp", 16), ("block", 0)):
        got = estep.fwd_store(**inp, tables=v2, route=route)
        assert all(torch.equal(a, b) for a, b in zip(got, (fwd, rows, offs)))
        got = estep.bwd_counts(*base, route=route)
        assert torch.equal(got[0], part) and torch.equal(got[1], sc)
    assert before == {f: [getattr(getattr(estep, f), k) for k in counts]
                      for f in ("fwd_store", "bwd_counts")}
    for bad in (("warp", 1), ("warp", 3), ("block", None), ("block", 8),
                ("tile", 0)):
        with pytest.raises(ValueError, match="no route"):
            estep.fwd_store(**inp, tables=v2, route=bad)
        with pytest.raises(ValueError, match="no route"):
            estep.bwd_counts(*base, route=bad)


def test_chip_smoke_route_helpers():
    """chip_smoke.py's E-step route helpers, pure functions of the width:
    the routes it holds against each other (the warp route where 512
    lanes cover the band, then the block route), and the check that a
    run's launch counts by route match its chunks' estep_route (a 423-lane
    chunk runs K2's warp route and K3's block route)."""
    import chip_smoke

    assert chip_smoke._estep_routes(3) == [("warp", 1), ("block", 0)]
    assert chip_smoke._estep_routes(168) == [("warp", 8), ("block", 0)]
    assert chip_smoke._estep_routes(512) == [("warp", 16), ("block", 0)]
    assert chip_smoke._estep_routes(513) == [("block", 0)]
    chunks = [{"B": 4, "W": 168}, {"B": 2, "W": 423}]
    n = {"fwd_store": {"warp_launches": 2, "block_launches": 0},
         "bwd_counts": {"warp_launches": 1, "block_launches": 1}}
    routes = chip_smoke._check_routes("a run", chunks, n)
    assert routes == [
        {"fwd_store": ("warp", 8), "bwd_counts": ("warp", 8)},
        {"fwd_store": ("warp", 16), "bwd_counts": ("block", 0)}]
    assert chip_smoke._route_text(chunks, routes) == (
        "(B=4, W=168: K2 warp 8, K3 warp 8); "
        "(B=2, W=423: K2 warp 16, K3 block)")
    n["bwd_counts"] = {"warp_launches": 2, "block_launches": 0}
    with pytest.raises(chip_smoke.SmokeFailure, match="bwd_counts"):
        chip_smoke._check_routes("a run", chunks, n)
