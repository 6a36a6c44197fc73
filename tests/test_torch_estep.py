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


def test_plain_fwd_store_wide_bands_hold_the_float64_fill():
    """Past ESTEP_WIDE_LANES K2's plain version runs the wide arithmetic
    (float64 cells, a log-add-exp's correction in float32, rows shifted by
    their largest match or insert cell), so on a global long-deletion band
    its forward score stays within 5e-3 nats of the float64 fill: the
    card tests' gap-order-1 band of 8192 lanes (its first pair: 618 rows
    over 3421 ref bases, 2800 deletions; prof/f32_chain.global_band, the
    card tests' recipe), on which the narrow-band arithmetic, float32
    cells, is 9.3e-3 nats off.  Each stored row's largest match or insert
    cell is 0 and its offset carries the rest.  One intra-op thread, as
    the wrappers' CPU paths: under the suite's workers more threads made
    this row-by-row fill a hundred times slower."""
    from quaff_tpu_torch.device import one_thread_on_cpu
    from quaff_tpu_torch.model.params import QuaffParams
    from quaff_tpu_torch.prof import f32_chain

    with open(pathlib.Path(__file__).parent / "data"
              / "params-gaporder1.json") as f:
        params = QuaffParams.from_json(f.read())
    inp, v2 = f32_chain.global_band(8192, 8209, 3, params)
    inp = {k: v[:1].contiguous() for k, v in inp.items()}
    ylen = int(inp["meta"][0, 1])
    inp["keys"] = inp["keys"][:, :ylen].contiguous()
    W = inp["doff"].shape[1]
    assert W > estep.ESTEP_WIDE_LANES and ylen == 618
    with one_thread_on_cpu(torch.device("cpu")):
        f64 = fill_v2.band_fill_reference(**inp, tables=v2, mode="forward",
                                          local=False, dtype=torch.float64)[0]
        fwd, rows, offs = estep.fwd_store(**inp, tables=v2, local=False)
        narrow_rows = torch.full_like(rows, fill_v2.NEG_INF)
        narrow = fill_v2.band_fill_reference(
            **inp, tables=v2, mode="forward", local=False, rows=narrow_rows,
            offsets=torch.zeros_like(offs))[0]
    assert fwd.dtype == torch.float32 and rows.dtype == torch.float32
    assert abs(float(fwd[0]) - float(f64)) < 5e-3
    live = rows > fill_v2.NEG_INF / 2
    top = torch.where(live[:2], rows[:2], float("-inf")).amax(dim=(0, 3))
    assert bool((top[0, :ylen] == 0).all())
    assert abs(float(narrow) - float(f64)) > 9e-3


def _engine_batch(inp):
    """The exact engine's bounding-band batch (dp/counts.dp_forward_backward)
    for K2's and K3's inputs of one strip over every diagonal
    (prof/f32_chain.global_band): lane w holds diagonal doff[w] = d_lo + w,
    the read's keys give its tokens, k-mers, qualities and indel contexts."""
    meta, doff, keys = (inp[k].long() for k in ("meta", "doff", "keys"))
    B = doff.shape[0]
    return {"x_tok": inp["x_tok"], "x_len": meta[:, 0],
            "y_tok": keys[..., 2], "y_match_kmer": keys[..., 0],
            "y_indel_kmer_pad": torch.cat(
                [torch.zeros((B, 1), dtype=torch.long), keys[..., 3]], 1),
            "y_qual": keys[..., 1], "y_has_qual": meta[:, 2].bool(),
            "y_len": meta[:, 1], "d_lo": doff[:, 0],
            "member": doff != fill_v2.D_SENTINEL}


def test_plain_bwd_counts_wide_bands_hold_the_float64_fill():
    """Past ESTEP_BWD_F64_LANES K3's plain version runs float64 cells (its
    backward cells, weights and their sums), as its smem route does, so on
    a global long-deletion band its back-start posterior and counts hold
    the float64 exact engine (dp/counts.py in float64): the card tests'
    gap-order-1 band of 8192 lanes (its first pair: 618 rows over 3421 ref
    bases, 2800 deletions; prof/f32_chain.global_band), forced to the wide
    arithmetic (the band is narrower than the route's threshold; its
    default there is float32 cells), normalised by the engine's forward
    score.  The posterior exp(back - fwd) is held to exp(f64 - fnorm), the
    float32 normaliser's own rounding, within 1e-3 (7.3e-5 measured on a
    CPU host; the float32 cells, the default on this band, left it 5.6e-3
    off, so the bound tells the two apart), the counts within the counts'
    rtol 3e-3 / atol 5e-3.  One intra-op thread, as the wrappers' CPU
    paths."""
    from quaff_tpu_torch.device import one_thread_on_cpu
    from quaff_tpu_torch.dp.counts import dp_forward_backward
    from quaff_tpu_torch.dp.engine import table_tensors
    from quaff_tpu_torch.model.params import QuaffParams
    from quaff_tpu_torch.prof import f32_chain

    with open(pathlib.Path(__file__).parent / "data"
              / "params-gaporder1.json") as f:
        params = QuaffParams.from_json(f.read())
    inp, v2 = f32_chain.global_band(8192, 8209, 3, params)
    inp = {k: v[:1].contiguous() for k, v in inp.items()}
    ylen = int(inp["meta"][0, 1])
    inp["keys"] = inp["keys"][:, :ylen].contiguous()
    W = inp["doff"].shape[1]
    assert estep.ESTEP_WIDE_LANES < W <= estep.ESTEP_BWD_F64_LANES
    assert ylen == 618
    with one_thread_on_cpu(torch.device("cpu")):
        exact = dp_forward_backward(
            table_tensors(ScoreTables.from_params(params)), _engine_batch(inp),
            local=False, dtype=torch.float64,
            num_match_kmers=params.num_match_kmers,
            num_indel_kmers=params.num_indel_kmers)
        f64 = exact["fwd_score"]
        _, rows, offs = estep.fwd_store(**inp, tables=v2, local=False)
        wrow = torch.stack([torch.ones(1), f64.float()]).contiguous()
        base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2,
                wrow, rows, offs)
        part, sc = estep.bwd_counts_reference(*base, local=False, wide=True)
    assert part.dtype == torch.float32 and sc.dtype == torch.float32
    want = torch.exp(f64 - f64.float().double())
    err = float((sc[4].double() - want).abs().max())
    print(f"back-start posterior off the float64 engine's: {err:.3g}")
    assert err < 1e-3
    got = estep.unpack_counts(part[0].double().numpy(), v2)
    for k, v in got.items():
        np.testing.assert_allclose(v, exact[k][0].numpy(), err_msg=k,
                                   **COUNTS)
    for i, k in enumerate(("i2i", "i2m", "d2d", "d2m")):
        np.testing.assert_allclose(float(sc[i, 0]), float(exact[k][0]),
                                   err_msg=k, **COUNTS)


# sha256 (first 32 hex digits) of K2's plain outputs (forward scores, rows,
# offsets) and K3's (tables, per-pair sums) on bands of at most
# ESTEP_WIDE_LANES, computed by the code before the wide arithmetic went
# to float64 cells (the narrow-band arithmetic was not touched)
NARROW_DIGESTS = {
    (600, True, "packed", 48): "6c810762b7d709ea68f60578ccf1491d",
    (4096, True, "gaporder1", 40): "fdcc0031728a0c95f7c2c029cea5acc8",
    (4096, False, "packed", 160): "2bc3b48c1e108bef585c899900f3799a"}


@pytest.mark.parametrize("case", sorted(NARROW_DIGESTS), ids=str)
def test_narrow_bands_keep_their_arithmetic(case):
    """Bands of at most ESTEP_WIDE_LANES lanes (every band of the train
    path: the trainer's ESTEP_LANE_CAP) keep the narrow-band arithmetic
    bit for bit: the plain K2's forward scores, stored rows and offsets
    and the plain K3's tables and per-pair sums hash to the digests the
    code gave before the wide arithmetic changed; the wide arithmetic on
    the same band changes them (so the digest sees the arithmetic)."""
    import hashlib

    from quaff_tpu_torch.device import one_thread_on_cpu
    from test_torch_kernel_cuda import _tables, random_fill_inputs

    W, local, tables, Ly = case
    kw = dict(Lx=W + 64, Ly=Ly) if local else dict(Lx=W // 2 + 64, Ly=Ly)
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 1),
                                 _tables(tables), W, B=2, local=local,
                                 device="cpu", **kw)

    def digest(fwd, rows, offs):
        fin = fwd > fill_v2.NEG_INF / 2
        wrow = torch.stack([torch.full_like(fwd, 0.5),
                            torch.where(fin, fwd, 0.0)]).float().contiguous()
        part, sc = estep.bwd_counts(inp["x_tok"], inp["keys"], inp["meta"],
                                    inp["doff"], v2, wrow, rows, offs,
                                    local=local)
        h = hashlib.sha256()
        for t in (fwd, rows, offs, part, sc):
            h.update(t.contiguous().numpy().tobytes())
        return h.hexdigest()[:32]

    assert W <= estep.ESTEP_WIDE_LANES
    assert digest(*estep.fwd_store(**inp, tables=v2, local=local)) == \
        NARROW_DIGESTS[case]
    B, Lyy = inp["doff"].shape[0], inp["keys"].shape[1]
    rows = torch.full((3, B, Lyy, W), fill_v2.NEG_INF)
    offs = torch.zeros((B, Lyy), dtype=torch.float64)
    with one_thread_on_cpu(torch.device("cpu")):
        fwd = fill_v2.band_fill_reference(**inp, tables=v2, mode="forward",
                                          local=local, rows=rows,
                                          offsets=offs, wide=True)[:B]
    assert digest(fwd, rows, offs) != NARROW_DIGESTS[case]


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


def _cluster_route(W, kernel):
    return "cluster", fill_v2.cluster_tiling(W,
                                             estep.ESTEP_CLUSTER_TABLE[kernel])


def _smem_route(W, kernel):
    return "smem", fill_v2.cluster_tiling(W, estep.ESTEP_SMEM_TABLE[kernel])


def _wide_route(W, kernel):
    """estep_route's route past the warp routes: the cluster route up to
    the kernel's ESTEP_CLUSTER_MAX_LANES, the smem route's shared tier up
    to its ESTEP_SMEM_MAX_LANES, its global tier past it."""
    if W <= estep.ESTEP_CLUSTER_MAX_LANES[kernel]:
        return _cluster_route(W, kernel)
    if W <= estep.ESTEP_SMEM_MAX_LANES[kernel]:
        return _smem_route(W, kernel)
    return _global_route(W)


def _global_route(W):
    return "global", fill_v2.global_tiling(W, estep.ESTEP_GLOBAL_WARPS)


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
@pytest.mark.parametrize("lpt", [1, 2, 4, 8, 16, None])
def test_estep_route_table(kernel, lpt):
    """K2's and K3's routes are a pure function of the band's width: every
    width up to the kernel's ESTEP_WARP_MAX_LANES takes the warp route
    with the smallest lanes-a-thread whose warp (32 * lpt lanes) covers it
    (the widths 16*lpt+1 .. 32*lpt), every wider band up to the kernel's
    ESTEP_CLUSTER_MAX_LANES the cluster route at the tiling of the first
    row of its ESTEP_CLUSTER_TABLE that covers it, up to its
    ESTEP_SMEM_MAX_LANES the smem route's shared tier at the tiling of its
    ESTEP_SMEM_TABLE, every band past that the smem route's global tier at
    global_tiling's (lpt None: the 4096 widths past the cutover); no band
    takes a route of another kind."""
    cut = estep.ESTEP_WARP_MAX_LANES[kernel]
    assert cut in (256, 512)
    if lpt is None:
        widths = range(cut + 1, cut + 4097)
    else:
        widths = range(16 * lpt + 1 if lpt > 1 else 1, 32 * lpt + 1)
    for W in widths:
        if lpt is not None and 32 * lpt <= cut:
            want = ("warp", lpt)
        else:
            want = _wide_route(W, kernel)
        assert estep.estep_route(W, kernel) == want
    top = estep.ESTEP_CLUSTER_MAX_LANES[kernel]
    assert estep.estep_route(top, kernel)[0] == "cluster"
    assert estep.estep_route(top + 1, kernel)[0] == "smem"
    top = estep.ESTEP_SMEM_MAX_LANES[kernel]
    assert estep.estep_route(top, kernel)[0] == "smem"
    for W in (top + 1, 12 * top):
        assert estep.estep_route(W, kernel) == _global_route(W)


@pytest.mark.parametrize("W,lpt", [(1, 1), (32, 1), (33, 2), (64, 2),
                                   (65, 4), (128, 4), (129, 8), (256, 8),
                                   (257, 16), (512, 16), (513, None),
                                   (12070, None)])
def test_warp_lpt(W, lpt):
    """The warp routes' lanes a thread: the smallest of 1/2/4/8/16 whose
    warp covers the band, none past 512 lanes; estep_route takes it up to
    each kernel's cutover, past it the cluster route up to the kernel's
    ESTEP_CLUSTER_MAX_LANES, the smem route's shared tier up to its
    ESTEP_SMEM_MAX_LANES and its global tier past that."""
    assert estep.warp_lpt(W) == lpt
    for kernel, cut in estep.ESTEP_WARP_MAX_LANES.items():
        want = ("warp", lpt) if W <= cut else _wide_route(W, kernel)
        assert estep.estep_route(W, kernel) == want


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
def test_estep_cluster_table(kernel):
    """The kernel's ESTEP_CLUSTER_TABLE: rows of growing width up to
    ESTEP_CLUSTER_MAX_LANES at lanes a thread the kernels have, and at
    every width from the kernel's warp route's cutover to the last row the
    tiling it gives is one the kernel takes (at most
    ESTEP_CLUSTER_MAX_WARPS warps a CTA) that covers the band, with its
    tiles spread evenly (no CTA idle): one fold of at most MAX_TILES tiles
    over at most MAX_CLUSTER_CTAS CTAs up to ESTEP_WIDE_LANES, the
    trainer's ESTEP_LANE_CAP (the train path keeps its narrow-band
    arithmetic), and past it (K3's rows alone: K2's float64 cells take the
    smem route there) the wide arithmetic with two levels over at most
    MAX_CLUSTER_CTAS2 CTAs."""
    from quaff_tpu_torch import trainer

    table = estep.ESTEP_CLUSTER_TABLE[kernel]
    assert set(estep.ESTEP_CLUSTER_TABLE) == {"fwd_store", "bwd_counts"}
    widths = [row[0] for row in table]
    assert widths == sorted(widths)
    assert widths[-1] == estep.ESTEP_CLUSTER_MAX_LANES[kernel] == {
        "fwd_store": 4096, "bwd_counts": 32768}[kernel]
    assert estep.ESTEP_WIDE_LANES == trainer.ESTEP_LANE_CAP == widths[0]
    assert table[0] == (4096, 4, 4)
    assert all(lpt in estep.ESTEP_CLUSTER_LPTS for _, lpt, _ in table)
    max_warps = estep.ESTEP_CLUSTER_MAX_WARPS[kernel]
    assert set(max_warps) == set(estep.ESTEP_CLUSTER_LPTS)
    for W in range(estep.ESTEP_WARP_MAX_LANES[kernel] + 1, widths[-1] + 1):
        route = estep.estep_route(W, kernel)
        nct, warps, lpt = route[1]
        assert route[0] == "cluster" and estep.estep_route_ok(W, route,
                                                              kernel)
        assert W <= nct * warps * 32 * lpt
        assert warps <= max_warps[lpt]
        narrow = W <= estep.ESTEP_WIDE_LANES
        assert nct * warps <= fill_v2.MAX_TILES or not narrow
        assert nct <= (fill_v2.MAX_CLUSTER_CTAS if narrow
                       else estep.MAX_CLUSTER_CTAS2)
        assert nct * warps <= estep.MAX_TILES2
        assert (nct - 1) * warps * 32 * lpt < W  # every CTA holds lanes
        assert estep.cluster_mode(W, route[1]) == (
            estep.ONE_FOLD if narrow else estep.TWO_FOLD)


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
def test_estep_smem_table(kernel):
    """The kernel's ESTEP_SMEM_TABLE: rows of growing width from past its
    cluster route up to its ESTEP_SMEM_MAX_LANES (K2 122880, K3 81920: the
    most lanes a thread whose run fits a CTA of 16 warps, 16 CTAs a pair),
    and at every width there the tiling it gives is one the shared tier
    takes (at most MAX_CLUSTER_CTAS2 CTAs of SMEM_MAX_WARPS warps, at most
    SMEM_MAX_LPT lanes a thread) that covers the band with every CTA
    holding lanes, spreads each pair over more than one SM, and keeps a
    CTA's run (K2 28 bytes a lane, K3 36: csrc/estep_smem.cu's
    kFwdLaneBytes and kBwdLaneBytes) and its fixed arrays (K2 8 KB of
    slots and end values; K3 4 KB of slots and its tiles' row statistics)
    inside the 227 KB a CTA of an H100 may hold; one more lane a thread
    at 16 CTAs of 16 warps would not fit.  Past the table the global tier
    takes 16 CTAs of 16 warps (global_tiling)."""
    import re

    from quaff_tpu_torch import kernels

    table = estep.ESTEP_SMEM_TABLE[kernel]
    assert set(estep.ESTEP_SMEM_TABLE) == {"fwd_store", "bwd_counts"}
    widths = [row[0] for row in table]
    assert widths == sorted(widths)
    assert widths[0] > estep.ESTEP_CLUSTER_MAX_LANES[kernel]
    assert widths[-1] == estep.ESTEP_SMEM_MAX_LANES[kernel] == {
        "fwd_store": 122880, "bwd_counts": 81920}[kernel]
    src = (pathlib.Path(kernels.__file__).parent / "csrc"
           / "estep_smem.cu").read_text()
    name = "kFwdLaneBytes" if kernel == "fwd_store" else "kBwdLaneBytes"
    doubles = int(re.search(name + r" = (\d) \* sizeof\(double\) \+ "
                            r"sizeof\(int\);", src).group(1))
    lane_bytes = {"fwd_store": 28, "bwd_counts": 36}[kernel]
    assert estep.ESTEP_SMEM_LANE_BYTES[kernel] == lane_bytes == 8 * doubles + 4
    for W in range(estep.ESTEP_CLUSTER_MAX_LANES[kernel] + 1, widths[-1] + 1,
                   97):
        route = estep.estep_route(W, kernel)
        nct, warps, lpt = route[1]
        assert route[0] == "smem" and estep.estep_route_ok(W, route, kernel)
        assert W <= nct * warps * 32 * lpt
        assert 1 < nct <= estep.MAX_CLUSTER_CTAS2
        assert warps <= estep.SMEM_MAX_WARPS and lpt <= estep.SMEM_MAX_LPT
        assert (nct - 1) * warps * 32 * lpt < W  # every CTA holds lanes
        fixed = 8192 if kernel == "fwd_store" else 4096 + 2 * nct * warps * 64
        assert estep.smem_cta_bytes(kernel, route[1]) == (
            lpt * warps * 32 * lane_bytes + fixed) <= 227 * 1024
    top = (16, 16, table[-1][1] + 1)
    assert estep.smem_cta_bytes(kernel, top) > estep.SMEM_CTA_BYTES
    assert _global_route(widths[-1] + 1)[1][2] == table[-1][1] + 1


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
@pytest.mark.parametrize("W", [4096, 4097, 16384, 16385, 32768, 32769,
                               65536, 65537, 81920, 81921, 122880, 122881])
def test_estep_route_bounds(W, kernel):
    """The routes at each bound: 4096 lanes the last of the narrow-band
    row (8 x 4 x 4, one fold, the narrow-band arithmetic); past it K2 the
    smem route (float64 cells: 3 lanes a thread, up to 8 warps a CTA to
    12288 lanes, 16 to 24576, 4 lanes a thread to 32768, then more), K3
    the wide
    arithmetic and two levels (4 lanes a thread and 4 warps up to 8192
    lanes, then 8 and 4; 16385-32768 8 and 8, over up to 16 CTAs), then
    its smem route (float64 cells); each kernel's shared tier up to its
    widest band (K3 81920 lanes, 10 a thread; K2 122880, 15 a thread), the
    global tier past it (16 CTAs of 16 warps, lanes a thread growing with
    the band).  estep_route_ok takes each route's tiling and refuses a
    one-fold tiling past 8 CTAs, a two-level one past 16 CTAs or the
    kernel's warps or any of K2's, an smem tiling past 16 CTAs, 16 warps or
    16 lanes a thread or whose run does not fit a CTA (where the global
    tier takes the same tiling), a tiling that does not cover the band,
    any cluster tiling past the kernel's ESTEP_CLUSTER_MAX_LANES, the
    former ("block", 0), and a fourth element."""
    ok = estep.estep_route_ok
    kind, tiling = estep.estep_route(W, kernel)
    assert not ok(W, ("block", 0), kernel)
    if W > estep.ESTEP_SMEM_MAX_LANES[kernel]:
        assert (kind, tiling) == _global_route(W)
        assert tiling[:2] == (16, 16) or W <= 122880
        assert ok(W, (kind, tiling), kernel)
        assert not ok(W, ("smem", tiling), kernel)  # its run does not fit
        for t in ((16, 8, 8), (16, 16, 4), (8, 8, 32)):
            assert not ok(W, ("cluster", t), kernel)
        for t in ((16, 16, 16), (16, 16, 9)):
            assert not ok(W, ("smem", t), kernel)
            assert ok(W, ("global", t), kernel) == (W <= 32 * 16 * 16 * t[2])
        assert not ok(W, (kind, tiling + (2,)), kernel)
        return
    want = {4096: ("cluster", (8, 4, 4)),
            4097: {"fwd_store": ("smem", (6, 8, 3)),
                   "bwd_counts": ("cluster", (9, 4, 4))},
            16384: {"fwd_store": ("smem", (11, 16, 3)),
                    "bwd_counts": ("cluster", (16, 4, 8))},
            16385: {"fwd_store": ("smem", (11, 16, 3)),
                    "bwd_counts": ("cluster", (9, 8, 8))},
            32768: {"fwd_store": ("smem", (16, 16, 4)),
                    "bwd_counts": ("cluster", (16, 8, 8))},
            32769: ("smem", (13, 16, 5)),
            65536: ("smem", (16, 16, 8)),
            65537: ("smem", (15, 16, 9)),
            81920: ("smem", (16, 16, 10)),
            81921: ("smem", (15, 16, 11)),
            122880: ("smem", (16, 16, 15))}[W]
    if isinstance(want, dict):
        want = want[kernel]
    assert (kind, tiling) == want
    assert ok(W, want, kernel)
    nct, warps, lpt = tiling
    assert not ok(W, (kind, tiling + (2,)), kernel)
    assert not ok(W + 32 * lpt * warps * nct, want, kernel)
    if kind == "smem":
        assert not ok(W, ("smem", (17, warps, lpt)), kernel)
        assert not ok(W, ("smem", (nct, 17, lpt)), kernel)
        assert not ok(W, ("smem", (nct, warps, 17)), kernel)
        assert not ok(W, ("smem", (16, 16, 16)), kernel)  # 16 lanes: no fit
        assert ok(W, ("global", (16, 16, 16)), kernel)
        assert ok(W, ("global", tiling), kernel)
        assert not ok(W, ("cluster", (16, 8, 8)), kernel) or (
            kernel == "bwd_counts" and W <= 32768)
        return
    assert estep.cluster_mode(W, tiling) == (
        estep.ONE_FOLD if W == 4096 else estep.TWO_FOLD)
    if W == 4096:
        assert not ok(W, ("cluster", (9, 3, 16)), kernel)  # one fold, 9
        # 36 tiles: two levels, K3's alone
        assert ok(W, ("cluster", (9, 4, lpt)), kernel) == (
            kernel == "bwd_counts")
        assert ok(W, ("smem", (9, 4, lpt)), kernel)
    else:
        assert ok(W, ("cluster", (nct, 4, 16)), kernel)  # fewer tiles
    assert not ok(W, ("cluster", (17, warps, lpt)), kernel)
    assert not ok(W, ("cluster", (nct, 17, 4)), kernel)


@pytest.mark.parametrize("kernel", ["fwd_store", "bwd_counts"])
def test_estep_cluster_route_ok_refuses(kernel):
    """A forced cluster tiling must be one the kernel has and cover the
    band: estep_route_ok refuses a tiling whose tiles do not cover W, one
    of more than MAX_CLUSTER_CTAS CTAs folded once (up to ESTEP_WIDE_LANES
    and MAX_TILES tiles) or MAX_CLUSTER_CTAS2 in two levels (K3's alone:
    K2's cluster route has one fold, its wide bands the smem route), more
    warps a CTA than the kernel takes (K3: 8 at any lanes a thread; K2: 8
    from 8 lanes a thread up, 16 below), lanes a thread the kernel has no
    instantiation of, a band wider than the kernel's
    ESTEP_CLUSTER_MAX_LANES, and anything that is not a (CTAs, warps,
    lanes) tuple; the wrappers raise on it before any launch, CPU tensors
    too.  Past ESTEP_WIDE_LANES every K3 cluster tiling takes two levels,
    so up to 16 CTAs.  A forced smem tiling takes up to 16 CTAs, warps and
    lanes a thread whose run fits a CTA (smem_cta_bytes), a forced global
    tiling any lanes a thread; a band of any width."""
    ok = estep.estep_route_ok
    k3 = kernel == "bwd_counts"
    assert ok(2048, ("cluster", (1, 4, 16)), kernel)
    assert ok(2048, ("cluster", (2, 2, 16)), kernel)
    assert not ok(2049, ("cluster", (1, 4, 16)), kernel)  # does not cover
    assert not ok(600, ("cluster", (1, 1, 4)), kernel)
    assert not ok(600, ("cluster", (9, 1, 4)), kernel)  # CTAs, one fold
    # more than 32 tiles: two levels, K3's
    assert ok(600, ("cluster", (8, 5, 4)), kernel) == k3
    assert ok(600, ("cluster", (12, 3, 4)), kernel) == k3  # 12 CTAs
    assert not ok(600, ("cluster", (17, 2, 4)), kernel)  # past 16 CTAs
    assert not ok(600, ("cluster", (1, 20, 2)), kernel)  # no lpt 2
    assert not ok(600, ("cluster", (1, 9, 16)), kernel)  # warps at lpt 16
    assert ok(600, ("cluster", (1, 10, 4)), kernel) == (kernel == "fwd_store")
    assert ok(600, ("cluster", (1, 9, 8)), kernel) is False  # warps at lpt 8
    assert ok(4096, ("cluster", (8, 4, 4)), kernel)
    assert ok(4096, ("cluster", (2, 4, 16)), kernel)
    # past 4096 lanes: K3's two levels, up to 16 CTAs, of few tiles too
    for W, tiling in ((4097, (8, 4, 8)), (8192, (8, 2, 16)),
                      (16384, (8, 4, 16)), (8192, (16, 1, 16))):
        assert ok(W, ("cluster", tiling), kernel) == k3
        assert estep.cluster_mode(W, tiling) == estep.TWO_FOLD
    top = estep.ESTEP_CLUSTER_MAX_LANES["bwd_counts"]
    assert ok(top, ("cluster", (16, 8, 8)), kernel) == k3
    assert ok(top, ("cluster", (8, 8, 16)), kernel) == k3  # 8 CTAs
    for W, tiling in ((top + 1, (16, 8, 8)), (top + 1, (8, 16, 16))):
        assert not ok(W, ("cluster", tiling), kernel)  # past the cap
    # the smem route: the shared tier any lanes a thread up to 16 whose
    # run fits a CTA, 16 CTAs of 16 warps; the global tier any lanes
    for W, tiling in ((600, (1, 2, 16)), (600, (3, 2, 4)),
                      (4097, (16, 1, 9)), (65536, (16, 16, 8)),
                      (65536, (16, 8, 16))):
        assert ok(W, ("smem", tiling), kernel)
        assert ok(W, ("global", tiling), kernel)
    for W, tiling in ((600, (1, 1, 15)), (600, (17, 1, 16)),
                      (600, (1, 17, 16)), (600, (1, 2, 17)),
                      (65536, (8, 16, 16)), (65537, (16, 16, 16)),
                      (600, (0, 1, 16))):
        assert not ok(W, ("smem", tiling), kernel)
    for W, tiling in ((600, (1, 1, 19)), (600, (1, 2, 17)),
                      (65536, (8, 16, 16)), (10**6, (16, 16, 123)),
                      (10**6, (1, 1, 31250))):
        assert ok(W, ("global", tiling), kernel)
    for W, tiling in ((600, (1, 1, 18)), (600, (17, 1, 16)),
                      (600, (1, 17, 16)), (600, (1, 1, 0)),
                      (10**6, (16, 16, 122))):
        assert not ok(W, ("global", tiling), kernel)
    for bad in (("cluster", None), ("cluster", (1, 4)), ("cluster", 0),
                ("cluster", (1, 4, 4, 2)), ("cluster", (12, 1, 4, 2)),
                ("smem", (1, 4)), ("smem", (1, 4, 4, 2)), ("smem", None),
                ("global", (1, 4)), ("global", None), ("block", 0), None,
                ("warp",)):
        assert not ok(600, bad, kernel)
    from test_torch_kernel_cuda import _tables, random_fill_inputs

    inp, v2 = random_fill_inputs(np.random.default_rng(4), _tables("packed"),
                                 600, B=1, Lx=60, Ly=8, device="cpu")
    for bad in (("cluster", (1, 1, 4)), ("smem", (1, 1, 2)),
                ("global", (1, 1, 2)), ("block", 0)):
        with pytest.raises(ValueError, match="no route"):
            if kernel == "fwd_store":
                estep.fwd_store(**inp, tables=v2, route=bad)
            else:
                rows = torch.zeros((3, 1, 8, 600))
                estep.bwd_counts(inp["x_tok"], inp["keys"], inp["meta"],
                                 inp["doff"], v2, torch.ones((2, 1)), rows,
                                 torch.zeros((1, 8), dtype=torch.float64),
                                 route=bad)


def test_wide_read_routes_its_chunk_to_the_cluster_routes():
    """The fused E-step's chunk plan groups reads by rows, longest first,
    not by width, and a chunk launches at its widest read's band: one read
    with a 4038-lane band (phase 4's recipe has one, read 369) puts every
    pair of its chunk on K2's and K3's cluster routes, while the chunks of
    narrow reads stay on the warp routes."""
    import types

    from quaff_tpu_torch import trainer

    rng = np.random.default_rng(369)
    counter = types.SimpleNamespace(
        tables=ScoreTables.from_params(port_params(jax_default_params())))

    def pair_bytes(width, rows, x_len):
        return trainer.QuaffCounter._pair_bytes(counter, width, rows, x_len)

    reads = [(ny, int(rng.integers(2000, 10001)), int(rng.integers(30, 191)),
              [200_000, 200_000]) for ny in range(512)]
    reads[369] = (369, 8540, 4038, [200_000, 200_000])
    chunks, oversize = trainer.estep_chunk_plan(
        reads, pair_bytes, lane_cap=trainer.ESTEP_LANE_CAP)
    assert oversize == [] and sorted(sum(chunks, [])) == list(range(512))
    width = {ny: w for ny, _, w, _ in reads}
    wide = [c for c in chunks if 369 in c]
    assert len(wide) == 1 and len(wide[0]) > 1
    for c in chunks:
        W = max(width[ny] for ny in c)
        routes = {k: estep.estep_route(W, k)[0]
                  for k in ("fwd_store", "bwd_counts")}
        if c is wide[0]:
            assert W == 4038
            assert routes == {"fwd_store": "cluster", "bwd_counts": "cluster"}
        else:
            assert W <= 190
            assert routes == {"fwd_store": "warp", "bwd_counts": "warp"}


def test_chunk_plan_counts_the_global_tier_slab(monkeypatch):
    """The fused E-step's chunk plan counts the smem routes' global-tier
    slab where a band takes it (estep.global_scratch_bytes: the larger of
    K2's 28 and K3's 36 bytes a lane of a pair's 16 CTAs of 16 warps), and
    nothing more for narrower bands, so a chunk cannot overrun the card;
    it is a function of the widths alone: the same plan whatever the
    card's free memory reports, or when asking raises.  (K3's global tier
    starts past 81920 lanes, K2's past 122880.)"""
    import types

    from quaff_tpu_torch import trainer

    counter = types.SimpleNamespace(
        tables=ScoreTables.from_params(port_params(jax_default_params())))

    def pair_bytes(width, rows, x_len):
        return trainer.QuaffCounter._pair_bytes(counter, width, rows, x_len)

    Km, Q = counter.tables.match_score.shape[1:3]
    table = 4 * (4 * Km * Q + 4 * Q + 4 * len(counter.tables.m2m))
    for W, slab in ((4038, 0), (66401, 0), (81920, 0),
                    (81921, 15 * 16 * 32 * 11 * 36),
                    (122881, 16 * 16 * 32 * 16 * 36),
                    (132401, 16 * 16 * 32 * 17 * 36)):
        assert estep.global_scratch_bytes(W) == slab
        assert pair_bytes(W, 400, 132_000) == (
            12 * W * 400 + table + 32 * W + 132_000 + 16 * 400 + slab)
        assert (slab > 0) == any(estep.estep_route(W, k)[0] == "global"
                                 for k in ("fwd_store", "bwd_counts"))
    # two reads of 400 rows with a 132401-lane band: the budget holds
    # them without their slabs, not with them
    reads = [(0, 400, 132401, [132_000]), (1, 400, 132401, [132_000])]
    bare = pair_bytes(132401, 400, 132_000) - estep.global_scratch_bytes(
        132401)
    budget = 2 * bare + estep.global_scratch_bytes(132401)
    plan = trainer.estep_chunk_plan(reads, pair_bytes, budget=budget)
    assert plan == ([[0], [1]], [])

    def no_info(device=None):
        raise RuntimeError("the chunk plan must not read free memory")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_info)
    assert trainer.estep_chunk_plan(reads, pair_bytes, budget=budget) == plan
    assert trainer.estep_chunk_plan(reads, pair_bytes) == ([[0, 1]], [])


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
    counts = ("launches", "warp_launches", "cluster_launches",
              "smem_launches", "global_launches", "two_level_launches")
    before = {f: [getattr(getattr(estep, f), k) for k in counts]
              for f in ("fwd_store", "bwd_counts")}
    for route in (None, ("warp", 2), ("warp", 16), ("cluster", (1, 1, 4)),
                  ("cluster", (2, 1, 8)), ("cluster", (1, 3, 16)),
                  ("cluster", (9, 4, 4)), ("smem", (1, 1, 2)),
                  ("smem", (2, 1, 1)), ("global", (1, 1, 2)),
                  ("global", (2, 1, 1)), ("global", (1, 1, 40))):
        if route != ("cluster", (9, 4, 4)):  # two levels: K3's alone
            got = estep.fwd_store(**inp, tables=v2, route=route)
            assert all(torch.equal(a, b)
                       for a, b in zip(got, (fwd, rows, offs)))
        got = estep.bwd_counts(*base, route=route)
        assert torch.equal(got[0], part) and torch.equal(got[1], sc)
    assert before == {f: [getattr(getattr(estep, f), k) for k in counts]
                      for f in ("fwd_store", "bwd_counts")}
    for bad in (("warp", 1), ("warp", 3), ("block", 0), ("block", None),
                ("block", 8), ("tile", 0), ("cluster", (1, 1, 1)),
                ("cluster", (9, 1, 4)), ("cluster", (1, 1, 2)),
                ("cluster", (1, 40, 4)), ("cluster", (1, 1, 4, 2)),
                ("cluster", 4), ("smem", (1, 1, 1)), ("smem", (17, 1, 2)),
                ("smem", (1, 1, 17)), ("global", (1, 1, 1)),
                ("global", (17, 1, 2)), ("global", (1, 17, 2)),
                ("global", 4)):
        with pytest.raises(ValueError, match="no route"):
            estep.fwd_store(**inp, tables=v2, route=bad)
        with pytest.raises(ValueError, match="no route"):
            estep.bwd_counts(*base, route=bad)


def test_chip_smoke_route_helpers():
    """chip_smoke.py's E-step route helpers, pure functions of the width:
    the routes it holds against each other (the warp route where 512
    lanes cover the band, the cluster route at the table's tiling up to
    the kernel's ESTEP_CLUSTER_MAX_LANES, else the smem route's shared tier
    with its global tier at the same tiling beside it, past the shared
    tier the global tier alone), the tilings its sweep times at phase
    4b's width (K3's two-level cluster tilings, K2's smem tilings), and the
    check that a run's launch counts by route match its chunks'
    estep_route (a 423-lane chunk runs K2's warp route and K3's cluster
    route, a 4038-lane one both cluster routes, a 22882-lane one K2's smem
    route and K3's two-level cluster route, a 35000-lane one both smem
    routes, a 132401-lane one both global tiers)."""
    import chip_smoke

    assert chip_smoke._estep_routes(3, "fwd_store") == [
        ("warp", 1), ("cluster", (1, 1, 4))]
    assert chip_smoke._estep_routes(168, "bwd_counts") == [
        ("warp", 8), _cluster_route(168, "bwd_counts")]
    assert chip_smoke._estep_routes(512, "fwd_store") == [
        ("warp", 16), _cluster_route(512, "fwd_store")]
    for k in ("fwd_store", "bwd_counts"):
        for W in (4038, 4097, 22882, 35000, 66401, 132401):
            r = _wide_route(W, k)
            assert chip_smoke._estep_routes(W, k) == [r] + (
                [("global", r[1])] if r[0] == "smem" else [])
        assert chip_smoke._estep_routes(132401, k) == [_global_route(132401)]
    assert _wide_route(4097, "fwd_store")[0] == "smem"
    assert _wide_route(22882, "bwd_counts")[0] == "cluster"
    assert _wide_route(35000, "bwd_counts")[0] == "smem"
    mw = estep.ESTEP_CLUSTER_MAX_WARPS["bwd_counts"].get
    swept = chip_smoke._sweep_tilings(22136, estep.ESTEP_CLUSTER_LPTS, mw,
                                      two_level=True)
    assert _cluster_route(22136, "bwd_counts")[1] == (11, 8, 8)
    assert {(11, 8, 8), (13, 7, 8), (15, 6, 8), (6, 8, 16),
            (8, 6, 16)} <= set(swept)
    for nct, warps, lpt in swept:
        assert 32 < nct * warps <= estep.MAX_TILES2
        assert estep.estep_route_ok(22136, ("cluster", (nct, warps, lpt)),
                                    "bwd_counts")
    assert len({t[1:] for t in swept}) == len(swept)
    assert chip_smoke._sweep_tilings(22136, estep.ESTEP_CLUSTER_LPTS,
                                     mw) == []
    smem = chip_smoke._smem_tilings(22136)
    assert _smem_route(22136, "fwd_store")[1] == (15, 16, 3) in smem
    for k in ("fwd_store", "bwd_counts"):
        # every one whose run fits a CTA (K2's all; K3's 36 bytes a lane
        # not at 16 warps of 13 or more lanes a thread)
        assert [estep.estep_route_ok(22136, ("smem", t), k)
                for t in smem] == [
            estep.smem_cta_bytes(k, t) <= estep.SMEM_CTA_BYTES for t in smem]
    assert all(estep.estep_route_ok(22136, ("smem", t), "fwd_store")
               for t in smem)
    assert len(set(smem)) == len(smem) and min(t[2] for t in smem) == 3
    chunks = [{"B": 4, "W": 168}, {"B": 2, "W": 423}, {"B": 14, "W": 4038},
              {"B": 8, "W": 22882}, {"B": 1, "W": 35000},
              {"B": 1, "W": 132401}]
    n = {"fwd_store": {"warp_launches": 2, "cluster_launches": 1,
                       "smem_launches": 2, "global_launches": 1},
         "bwd_counts": {"warp_launches": 1, "cluster_launches": 3,
                        "smem_launches": 1, "global_launches": 1}}
    routes = chip_smoke._check_routes("a run", chunks, n)
    assert routes == [
        {"fwd_store": ("warp", 8), "bwd_counts": ("warp", 8)},
        {"fwd_store": ("warp", 16),
         "bwd_counts": _cluster_route(423, "bwd_counts")},
        {k: _cluster_route(4038, k) for k in ("fwd_store", "bwd_counts")},
        {"fwd_store": _smem_route(22882, "fwd_store"),
         "bwd_counts": _cluster_route(22882, "bwd_counts")},
        {k: _smem_route(35000, k) for k in ("fwd_store", "bwd_counts")},
        {k: _global_route(132401) for k in ("fwd_store", "bwd_counts")}]
    t423 = "{} x {} x {}".format(*_cluster_route(423, "bwd_counts")[1])
    t35 = "{} x {} x {}".format(*_smem_route(35000, "bwd_counts")[1])
    assert chip_smoke._route_text(chunks[:2], routes[:2]) == (
        "(B=4, W=168: K2 warp 8, K3 warp 8); "
        f"(B=2, W=423: K2 warp 16, K3 cluster {t423})")
    assert chip_smoke._route_text(chunks[4:5], routes[4:5]) == (
        f"(B=1, W=35000: K2 smem {t35}, K3 smem {t35})")
    n["bwd_counts"] = {"warp_launches": 2, "cluster_launches": 2,
                       "smem_launches": 1, "global_launches": 1}
    with pytest.raises(chip_smoke.SmokeFailure, match="bwd_counts"):
        chip_smoke._check_routes("a run", chunks, n)
