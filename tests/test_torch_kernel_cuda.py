"""The port's CUDA kernels against their plain PyTorch versions on the
card, on identical inputs: K1 (quaff_tpu_torch/csrc/band_fill.cu, its warp
route at every lanes-a-thread instantiation, its cluster route at every
tiling its route table chooses and at forced ones, and its block route),
K2 and K3 (csrc/estep.cu: their warp routes at every lanes-a-thread
instantiation, their block routes, and each pairing of the two), the count
reduction (bit for bit), K4 (csrc/ov_fill.cu: its warp route at every
lanes-a-thread instantiation, its cluster route as K1's) and the probes'
chain kernel (csrc/sol_probe.cu).  Needs an NVIDIA GPU and skips without
one.  This file imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

(`-k cluster` selects the cluster routes' tests.)

Tolerances, the TPU kernels' own: scores rtol 1e-5 / atol 1e-3 (the
kernels sum their delete chains and Forward end reductions in another
order); counts rtol 3e-3 / atol 5e-3 (tests/test_pallas_counts.py);
overlap scores rtol 1e-5 / atol 0.05 (K4 and its plain version sum float32
cells in another order over thousands of rows; 0.05 is the JAX package's
K4 tolerance against its float64 fill, tests/test_pallas_overlap.py).
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


# parameter files of the table cases other than the default parameters:
# gap order 1, and -suborder 2 (match order 3, Km = 64: an E-step count
# table of 24444 floats, past what K3's warp route keeps in shared memory)
PARAMS_FILES = {"gaporder1": "params-gaporder1.json",
                "sub2": "c8f30-params-sub2.oracle.json"}


def _tables(case):
    params = (QuaffParams.from_json((DATA / PARAMS_FILES[case]).read_text())
              if case in PARAMS_FILES else default_params())
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


def random_fill_inputs(rng, tt, W, *, B=8, Lx=300, Ly=120, local=True,
                       qual=True, device="cuda", seams=None):
    """K1's inputs (fill_v2.kernel_inputs's layout) for B random pairs on a
    band of W lanes, with V2Tables of `tt`.  Local: 1-3 strips a pair at
    random diagonals, a few sentinel lanes inside and between them, and
    sentinel lanes after the last; with `seams` (lane positions from 0 to
    W) the strips are exactly [seams[k], seams[k+1]) instead, at random
    diagonals, their first and last lanes in the envelope.  Global: one
    strip over every diagonal of a ref and read that fit the band.  Read
    lengths vary below Ly; keys are random; with qual, about half the
    pairs have qualities."""
    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL, V2Tables

    v2 = V2Tables.from_tables(tt, device)
    Km, Q = v2.match.shape[1], v2.match.shape[2]
    S = 3
    keys = np.stack([rng.integers(0, Km, (B, Ly)), rng.integers(0, Q, (B, Ly)),
                     rng.integers(0, 4, (B, Ly)),
                     rng.integers(0, v2.n_ik, (B, Ly))], axis=2)
    meta = np.zeros((B, 4), np.int64)
    doff = np.full((B, W), D_SENTINEL, np.int64)
    seg_start = np.zeros((B, S), np.int64)
    seg_width = np.zeros((B, S), np.int64)
    for b in range(B):
        if local and seams is not None:
            ylen = int(rng.integers(Ly // 2, Ly + 1))
            xlen = int(rng.integers(Lx // 2, Lx + 1))
            _seam_strips(rng, doff[b], seg_start[b], seg_width[b], seams,
                         xlen, ylen)
        elif local:
            ylen = int(rng.integers(Ly // 2, Ly + 1))
            xlen = int(rng.integers(Lx // 2, Lx + 1))
            start = 0
            for k in range(int(rng.integers(1, S + 1))):
                if start >= W:
                    break
                wk = int(rng.integers(1, max(1, (W - start) // 2) + 1))
                d_lo = int(rng.integers(-(ylen - 1), xlen))
                seg_start[b, k], seg_width[b, k] = start, wk
                doff[b, start:start + wk] = d_lo + np.arange(wk)
                holes = start + np.nonzero(rng.random(wk) < 0.05)[0]
                doff[b, holes] = D_SENTINEL
                start += wk + int(rng.integers(0, 3))
        else:
            ylen = int(rng.integers(max(1, min(Ly, W) // 2), min(Ly, W) + 1))
            xlen = int(rng.integers(1, min(Lx, W - ylen + 1) + 1))
            seg_width[b, 0] = xlen + ylen - 1
            doff[b, :xlen + ylen - 1] = np.arange(-(ylen - 1), xlen)
        meta[b, :3] = xlen, ylen, int(qual and rng.random() < 0.5)

    def dev(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)

    inp = {"x_tok": dev(rng.integers(0, 4, (B, Lx)), torch.int8),
           "keys": dev(keys), "meta": dev(meta), "doff": dev(doff),
           "seg_start": dev(seg_start), "seg_width": dev(seg_width)}
    return inp, v2


def _seam_strips(rng, doff, seg_start, seg_width, seams, xlen, ylen):
    """One pair's strips [seams[k], seams[k+1]) at random diagonals that
    meet the pair's cells, a few sentinel lanes inside each but never its
    first or last lane (so a strip's last lane, at a tile's or a CTA's
    last lane, is in the envelope)."""
    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    for k, (a, z) in enumerate(zip(seams[:-1], seams[1:])):
        wk = z - a
        d_lo = int(rng.integers(-(ylen - 1), xlen)) - wk // 2
        seg_start[k], seg_width[k] = a, wk
        doff[a:z] = d_lo + np.arange(wk)
        holes = a + 1 + np.nonzero(rng.random(max(wk - 2, 0)) < 0.05)[0]
        doff[holes] = D_SENTINEL


# (mode, local, qualities, gap order) of each fill variant
FILL_VARIANTS = {
    "viterbi": ("viterbi", True, True, 0),
    "forward": ("forward", True, True, 0),
    "global": ("viterbi", False, True, 0),
    "forward-global": ("forward", False, True, 0),
    "noqual": ("viterbi", True, False, 0),
    "gaporder1": ("viterbi", True, True, 1),
}


def _assert_scores_close(got, ref, n_pairs):
    floor = fill_v2.NEG_INF / 2
    got = torch.where(got <= floor, float("-inf"), got).double().cpu().numpy()
    ref = torch.where(ref <= floor, float("-inf"), ref).double().cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin[:n_pairs].any()
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-3)


def _variant_inputs(variant, W, seed):
    mode, local, qual, gap = FILL_VARIANTS[variant]
    tt = _tables("gaporder1" if gap else "packed")
    inp, v2 = random_fill_inputs(np.random.default_rng(seed), tt, W,
                                 local=local, qual=qual)
    return inp, v2, mode, local


FILL_COUNTS = ("launches", "warp_launches", "cluster_launches",
               "block_launches")


def _fill_checked(inp, v2, mode, local, route=None):
    """K1 through the wrapper on `inp` (on `route` when given, else
    fill_route's), asserting that it launched once, on that route, and
    agrees with band_fill_reference within rtol 1e-5 / atol 1e-3."""
    kind = (route or fill_v2.fill_route(inp["doff"].shape[1]))[0]
    before = [getattr(fill_v2.band_fill, k) for k in FILL_COUNTS]
    got = fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local,
                            route=route)
    torch.cuda.synchronize()
    moved = [getattr(fill_v2.band_fill, k) - n
             for k, n in zip(FILL_COUNTS, before)]
    assert moved == [1] + [int(kind == k) for k in ("warp", "cluster",
                                                    "block")]
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode,
                                      local=local)
    _assert_scores_close(got, ref, inp["doff"].shape[0])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FILL_VARIANTS))
@pytest.mark.parametrize("W", [1, 31, 33, 100, 203, 512, 513])
def test_fill_routes_match_plain(W, variant):
    """K1 through the wrapper on random bands of W lanes: the warp route at
    its smallest lanes-a-thread (W = 1 and 31: 1, 33: 2, 100: 4, 203: 8,
    512: 16), the cluster route at 513, each against band_fill_reference;
    at 513 the block route forced on the same inputs too."""
    _need_card()
    inp, v2, mode, local = _variant_inputs(variant, W, 41 + W)
    _fill_checked(inp, v2, mode, local)
    if W > 32 * fill_v2.WARP_LPTS[-1]:
        _fill_checked(inp, v2, mode, local, ("block", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FILL_VARIANTS))
@pytest.mark.parametrize("lpt", fill_v2.WARP_LPTS)
def test_warp_route_every_lanes_a_thread(lpt, variant):
    """Each instantiation of the warp kernel on a 31-lane band (which every
    lpt covers), launched through its C entry, against the plain version."""
    _need_card()
    from quaff_tpu_torch import kernels

    inp, v2, mode, local = _variant_inputs(variant, 31, 7 * lpt)
    B, W = inp["doff"].shape
    S, Ly, Lx = inp["seg_start"].shape[1], inp["keys"].shape[1], \
        inp["x_tok"].shape[1]
    out = torch.empty(B + B * S, dtype=torch.float32, device="cuda")
    err = kernels.library().quaff_band_fill_warp(
        inp["x_tok"].data_ptr(), Lx, inp["keys"].data_ptr(), Ly,
        inp["meta"].data_ptr(), inp["doff"].data_ptr(), W,
        inp["seg_start"].data_ptr(), inp["seg_width"].data_ptr(), S,
        v2.match.data_ptr(), v2.match_noq.data_ptr(), v2.insert.data_ptr(),
        v2.insert_noq.data_ptr(), v2.match.shape[1], v2.match.shape[2],
        v2.ik.data_ptr(), v2.n_ik, v2.trans.data_ptr(), B,
        int(mode == "viterbi"), int(local), lpt, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err == 0, kernels.error_string(err)
    torch.cuda.synchronize()
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode, local=local)
    _assert_scores_close(out, ref, B)


@pytest.mark.cuda
def test_estep_reduce_bitwise():
    """The count reduction equals its plain version (the same float32 adds
    in the same order) bit for bit, and repeats bit for bit, at B=257
    (a ragged last row group) and E=1884 (a ragged last column tile)."""
    _need_card()
    rng = np.random.default_rng(53)
    part = torch.from_numpy(
        rng.random((257, 1884), dtype=np.float32) * 10).cuda()
    before = estep.estep_reduce.launches
    tab = estep.estep_reduce(part)
    torch.cuda.synchronize()
    assert estep.estep_reduce.launches == before + 1
    assert torch.equal(tab, estep.estep_reduce_reference(part))
    assert torch.equal(tab, estep.estep_reduce(part))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["packed", "gaporder1", "global", "wide"])
def test_estep_kernels_match_plain(case):
    """K2, K3 and the reduction against fwd_store_reference,
    bwd_counts_reference and estep_reduce_reference (bit for bit), each on
    the same inputs; then the whole E-step twice, with bit-identical count
    tables."""
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
    for got, want in ((part, part_p), (sc, sc_p)):
        np.testing.assert_allclose(got.double().cpu(), want.double().cpu(),
                                   rtol=3e-3, atol=5e-3)
    assert torch.equal(tab, estep.estep_reduce_reference(part))
    assert float(tab.sum()) > 0
    fwd2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local)
    part2, sc2 = estep.bwd_counts(*base[:6], rows2, offs2, local=local)
    assert torch.equal(fwd, fwd2) and torch.equal(sc, sc2)
    assert torch.equal(tab, estep.estep_reduce(part2))
    assert {k: getattr(estep, k).launches - v for k, v in n.items()} == {
        "fwd_store": 2, "bwd_counts": 2, "estep_reduce": 2}


# (local, table case) of each E-step variant; sub2's count table lives in
# partial itself on K3's warp route, the others' in shared memory
ESTEP_VARIANTS = {"local": (True, "packed"), "local-gap1": (True, "gaporder1"),
                  "global": (False, "packed"),
                  "global-gap1": (False, "gaporder1"),
                  "local-sub2": (True, "sub2")}


def _estep_plain(variant, W, seed):
    """K2's and K3's inputs on random bands of W lanes (random_fill_inputs)
    and their plain versions' outputs: (inp, v2, local, fwd_p, wrow,
    part_p, sc_p); wrow's weights are 0.5 and its normalisers the plain
    forward scores."""
    local, tables = ESTEP_VARIANTS[variant]
    inp, v2 = random_fill_inputs(np.random.default_rng(seed), _tables(tables),
                                 W, local=local)
    fwd_p, rows_p, offs_p = estep.fwd_store_reference(**inp, tables=v2,
                                                      local=local)
    fin = fwd_p > fill_v2.NEG_INF / 2
    wrow = torch.stack([torch.full_like(fwd_p, 0.5),
                        torch.where(fin, fwd_p, 0.0)]).contiguous()
    part_p, sc_p = estep.bwd_counts_reference(
        inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
        rows_p, offs_p, local=local)
    return inp, v2, local, fwd_p, wrow, part_p, sc_p


def _estep_routes_check(inp, v2, local, fwd_p, wrow, part_p, sc_p, routes):
    """Each (K2 route, K3 route) pair against the plain versions: forward
    scores rtol 1e-5 / atol 1e-3, tables and d_sc rtol 3e-3 / atol 5e-3,
    the back-start posterior of every finite pair within 5e-3 of 1, both
    kernels bit-identical on a second run, one launch counted on each
    kernel's route."""
    counts = ("launches", "warp_launches", "block_launches")
    fin = fwd_p > fill_v2.NEG_INF / 2
    assert bool(fin.any())
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow)
    for r2, r3 in routes:
        before = [getattr(estep.fwd_store, k) for k in counts]
        fwd, rows, offs = estep.fwd_store(**inp, tables=v2, local=local,
                                          route=r2)
        torch.cuda.synchronize()
        moved = [getattr(estep.fwd_store, k) - n
                 for k, n in zip(counts, before)]
        assert moved == [1, int(r2[0] == "warp"), int(r2[0] == "block")]
        assert torch.equal(fwd > fill_v2.NEG_INF / 2, fin)
        np.testing.assert_allclose(fwd[fin].double().cpu(),
                                   fwd_p[fin].double().cpu(),
                                   rtol=1e-5, atol=1e-3)
        before = [getattr(estep.bwd_counts, k) for k in counts]
        part, sc = estep.bwd_counts(*base, rows, offs, local=local, route=r3)
        torch.cuda.synchronize()
        moved = [getattr(estep.bwd_counts, k) - n
                 for k, n in zip(counts, before)]
        assert moved == [1, int(r3[0] == "warp"), int(r3[0] == "block")]
        for got, want in ((part, part_p), (sc, sc_p)):
            np.testing.assert_allclose(got.double().cpu(),
                                       want.double().cpu(),
                                       rtol=3e-3, atol=5e-3)
        bsp = sc[4][fin].double().cpu()
        assert float((bsp - 1).abs().max()) < 5e-3
        fwd2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local,
                                             route=r2)
        part2, sc2 = estep.bwd_counts(*base, rows2, offs2, local=local,
                                      route=r3)
        assert torch.equal(fwd, fwd2)
        assert torch.equal(part, part2) and torch.equal(sc, sc2)


# each kernel's cutover and the width past it
# the warp routes' cutovers, and the block routes at their shared-memory
# row state's 48 KB (K3's 8 words a lane at 1536 lanes, K2's 6 at 2048),
# past which the launch must opt in to more (the opt-in also counts the
# kernels' static arrays)
ESTEP_WIDTHS = sorted({3, 32, 33, 168, 256, 1536, 2048}.union(
    *({c, c + 1} for c in estep.ESTEP_WARP_MAX_LANES.values())))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(ESTEP_VARIANTS))
@pytest.mark.parametrize("W", ESTEP_WIDTHS)
def test_estep_routes_match_plain(W, variant):
    """K2 and K3 on random bands of W lanes (their strips end on member
    lanes, not on halo lanes), each route forced and each pairing of a K2
    route with a K3 route (the layout they share), against
    fwd_store_reference and bwd_counts_reference: the warp route at the
    smallest lanes-a-thread that covers W (up to 512 lanes) and the block
    route; then both kernels through estep_route's own route."""
    _need_card()
    case = _estep_plain(variant, W, 61 + W)
    routes = [("block", 0)]
    if estep.warp_lpt(W) is not None:
        routes.insert(0, ("warp", estep.warp_lpt(W)))
    pairs = [(r2, r3) for r2 in routes for r3 in routes]
    _estep_routes_check(*case, pairs + [(estep.estep_route(W, "fwd_store"),
                                         estep.estep_route(W, "bwd_counts"))])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(ESTEP_VARIANTS))
@pytest.mark.parametrize("lpt", fill_v2.WARP_LPTS)
def test_estep_warp_route_every_lanes_a_thread(lpt, variant):
    """Each instantiation of K2's and K3's warp kernels on a 31-lane band
    (which every lpt covers) against the plain versions."""
    _need_card()
    case = _estep_plain(variant, 31, 13 * lpt)
    _estep_routes_check(*case, [(("warp", lpt), ("warp", lpt))])


def bounding_band_desc(pairs):
    """(member, seg_d_lo, seg_start, seg_width, j_off, n_rows) of one strip
    per pair spanning its envelope's bounding band, every row live: the
    layout of a bounding-band batch (PairBatch.build) in K4's strip form."""
    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL

    B = len(pairs)
    W = max(e.band_width for *_, e in pairs)
    member = np.zeros((B, W), bool)
    for b, (*_, env) in enumerate(pairs):
        mask = env.member_mask()
        member[b, : len(mask)] = mask
    seg_d_lo = np.array([[e.band_lo] for *_, e in pairs], np.int32)
    assert (seg_d_lo != D_SENTINEL).all()
    return (member, seg_d_lo, np.zeros((B, 1), np.int32),
            np.full((B, 1), W, np.int32), np.zeros(B, np.int32),
            np.array([len(y.seq) for _, y, _ in pairs], np.int32))


def overlap_bank_batch(pairs, tables, desc, device):
    """K4's chunk input (dp/ov_fill.prepare's batch) for (x, y, envelope)
    pairs on `device`: a sequence bank with one x row and one y row per
    pair, made by bank_rows from each read's arrays as the overlap
    pipeline makes its bank, and `desc`, the pairs' (member, seg_d_lo,
    seg_start, seg_width, j_off, n_rows)."""
    from quaff_tpu_torch.dp import ov_fill
    from quaff_tpu_torch.overlap import _insert_score_sum, _y_strand_arrays

    B = len(pairs)
    L = max(max(len(x.seq), len(y.seq)) for x, y, _ in pairs)
    tabs = ov_fill.ov_tables(tables, device)
    rows, ins = [], []
    for side in ("x", "y"):
        arr = np.zeros((4, B, L), np.int32)  # tokens, k-mers, qualities
        hq, lens, sums = np.zeros(B, bool), np.zeros(B, np.int32), []
        for b, (x, y, _) in enumerate(pairs):
            if side == "x":
                tok = x.tokens()
                q = x.qual_scores() if x.has_qual() else None
                mk = x.kmers(tables.match_kmer_len)
                ik = x.kmers(tables.indel_kmer_len)
            else:
                tok, mk, ik, q = _y_strand_arrays(y, tables)
            n = len(tok)
            arr[0, b, :n], arr[1, b, :n], arr[2, b, :n] = tok, mk, ik
            if q is not None:
                arr[3, b, :n], hq[b] = q, True
            lens[b] = n
            sums.append(_insert_score_sum(tables, tok, q))
        t = torch.from_numpy(arr).to(device)
        rows.append(ov_fill.bank_rows(
            tabs, side, t[0], t[1], t[2], t[3], torch.from_numpy(hq).to(device),
            torch.from_numpy(lens).to(device)))
        ins.append(sums)
    names = ("member", "seg_d_lo", "seg_start", "seg_width", "j_off", "n_rows")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
             for k, v in zip(names, desc)}
    batch.update(
        bank=torch.cat(rows).contiguous(),
        x_row=torch.arange(B, device=device),
        y_row=torch.arange(B, 2 * B, device=device),
        x_len=torch.tensor([len(x.seq) for x, _, _ in pairs], device=device),
        y_len=torch.tensor([len(y.seq) for _, y, _ in pairs], device=device),
        x_insert_score=torch.tensor(ins[0], dtype=torch.float64, device=device),
        y_insert_score=torch.tensor(ins[1], dtype=torch.float64, device=device),
    )
    return batch


def _overlap_batch(case, rng):
    """Lane-packed overlap pairs on distant diagonals (multi-strip
    envelopes with a dead leading-row region), on the card."""
    from quaff_tpu_torch.dp import ov_fill
    from quaff_tpu_torch.dp.overlap import OverlapScoreTables

    params = (QuaffParams.from_json((DATA / "params-gaporder1.json").read_text())
              if case == "gaporder1" else default_params())
    tables = OverlapScoreTables.from_params(params, case == "reverse")
    base = "".join("acgt"[t] for t in rng.integers(0, 4, 3000))
    pairs = []
    for b in range(12):
        xl, x0 = int(rng.integers(900, 1400)), int(rng.integers(0, 400))
        yl, y0 = int(rng.integers(600, 900)), int(rng.integers(1000, 2000))
        ys = list(base[y0 : y0 + yl])
        for i in range(len(ys)):
            if rng.random() < 0.08:
                ys[i] = "ACGT"[int(rng.integers(0, 4))]

        def qual(n):
            if case == "noqual":
                return ""
            return "".join(chr(33 + int(q)) for q in rng.integers(3, 40, n))

        x = FastSeq(name=f"x{b}", seq=base[x0 : x0 + xl], qual=qual(xl))
        y = FastSeq(name=f"y{b}", seq="".join(ys), qual=qual(yl))
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=64,
                              kmer_threshold=14)
        pairs.append((x, y, env))
    desc = ov_fill.packed_overlap_descriptors(
        [e for *_, e in pairs], [len(x.seq) for x, _, _ in pairs],
        [len(y.seq) for _, y, _ in pairs])
    return ov_fill.prepare(ov_fill.ov_tables(tables, "cuda"),
                           overlap_bank_batch(pairs, tables, desc, "cuda"))


def random_ov_inputs(rng, W, *, B=8, L=160, gap_order=0, device="cuda",
                     seams=None, full=False):
    """K4's inputs (dp/ov_fill.prepare's layout) for B random pairs on a
    band of W lanes: a bank of B x rows then B y rows [2B, C, L] with
    log-score-like values (match channels -inf, the others 0 past each
    read's length, as bank_rows makes them), 1-3 strips a pair at random
    diagonals with a few sentinel lanes inside and between them, sentinel
    lanes after the last (with `seams`, the strips [seams[k], seams[k+1])
    of _seam_strips; with full=True one strip over the band from the
    pair's first diagonal, -(y_len - 1), so that most lanes are live in a
    few of the pair's rows only), the live-row window of
    packed_overlap_descriptors, and the transitions of the shipped
    parameters (gap order 0) or params-gaporder1.json."""
    from quaff_tpu_torch.dp import ov_fill
    from quaff_tpu_torch.dp.fill_v2 import D_SENTINEL
    from quaff_tpu_torch.dp.overlap import OverlapScoreTables

    params = (QuaffParams.from_json((DATA / "params-gaporder1.json").read_text())
              if gap_order else default_params())
    trans = ov_fill.ov_tables(OverlapScoreTables.from_params(params, False),
                              device).trans
    C, S = (7 if gap_order else 5), ov_fill.MAX_SEGS
    lens = rng.integers(L // 2, L + 1, 2 * B)
    bank = np.zeros((2 * B, C, L), np.float32)
    bank[:, :4] = rng.uniform(-4.0, -0.2, (2 * B, 4, L))
    bank[:, 4] = rng.uniform(-1.6, -1.2, (2 * B, L))
    if gap_order:
        bank[:, 5] = rng.uniform(-6.0, -3.0, (2 * B, L))
        bank[:, 6] = rng.uniform(-0.6, -0.05, (2 * B, L))
    past = np.arange(L)[None, :] >= lens[:, None]
    for c in range(C):
        bank[:, c][past] = -np.inf if c < 4 else 0.0
    meta = np.zeros((B, 8), np.int64)
    doff = np.full((B, W), D_SENTINEL, np.int64)
    seg_start = np.zeros((B, S), np.int64)
    seg_width = np.zeros((B, S), np.int64)
    for b in range(B):
        xlen, ylen = int(lens[b]), int(lens[B + b])
        start = W if seams is not None or full else 0
        if seams is not None:
            _seam_strips(rng, doff[b], seg_start[b], seg_width[b], seams,
                         xlen, ylen)
        elif full:
            seg_width[b, 0] = W
            doff[b] = -(ylen - 1) + np.arange(W)
        for k in range(int(rng.integers(1, S + 1))):
            if start >= W:
                break
            wk = int(rng.integers(1, max(1, (W - start) // 2) + 1))
            if k == 0:
                wk = max(wk, min(W, 8))
            d_lo = int(rng.integers(-(ylen - 1), xlen))
            seg_start[b, k], seg_width[b, k] = start, wk
            doff[b, start:start + wk] = d_lo + np.arange(wk)
            holes = start + np.nonzero(rng.random(wk) < 0.05)[0]
            doff[b, holes] = D_SENTINEL
            start += wk + int(rng.integers(0, 3))
        live = doff[b][doff[b] != D_SENTINEL]
        if live.size == 0:
            doff[b, 0] = 0
            live = doff[b, :1]
        d1, d2 = int(live.min()), int(live.max())
        j0 = max(1, 1 - d2)
        rows = max(min(ylen, xlen - d1) - j0 + 1, 1)
        meta[b, :6] = b, B + b, xlen, ylen, j0 - 1, rows
    ins_xy = np.stack([-1.4 * lens[:B], -1.4 * lens[B:]], axis=1)

    def dev(a, dt=torch.int32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)

    return {"bank": dev(bank, torch.float32), "meta": dev(meta),
            "doff": dev(doff), "seg_start": dev(seg_start),
            "seg_width": dev(seg_width),
            "ins_xy": dev(ins_xy, torch.float32), "trans": trans}


OV_COUNTS = ("launches", "warp_launches", "cluster_launches")


def _ov_checked(inp, route=None):
    """K4 through the wrapper on `inp` (on `route` when given, else
    ov_route's), asserting that it launched once, on that route, and
    agrees with ov_fill_reference within rtol 1e-5 / atol 0.05."""
    from quaff_tpu_torch.dp import ov_fill

    kind, _ = route or ov_fill.ov_route(inp["doff"].shape[1])
    before = [getattr(ov_fill.ov_fill, k) for k in OV_COUNTS]
    got = ov_fill.ov_fill(**inp, route=route)
    torch.cuda.synchronize()
    moved = [getattr(ov_fill.ov_fill, k) - n
             for k, n in zip(OV_COUNTS, before)]
    assert moved == [1, int(kind == "warp"), int(kind == "cluster")]
    ref = ov_fill.ov_fill_reference(**inp)
    got_np, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    np.testing.assert_array_equal(np.isfinite(got_np), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin[: inp["meta"].shape[0]].any()
    np.testing.assert_allclose(got_np[fin], ref[fin], rtol=1e-5, atol=0.05)
    return fin, got


def _ov_cluster_route(W):
    """The cluster route at OV_CLUSTER_TABLE's tiling for W lanes (for a
    band the warp route takes, the table's first row's)."""
    from quaff_tpu_torch.dp import ov_fill

    return "cluster", fill_v2.cluster_tiling(W, ov_fill.OV_CLUSTER_TABLE)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["routed", "cluster"])
@pytest.mark.parametrize("case", ["forward", "reverse", "noqual", "gaporder1"])
def test_ov_fill_matches_plain(case, route):
    """K4 against ov_fill_reference on lane-packed overlap pairs (W=70):
    pair scores and strip maxima, on the route ov_route picks (the warp
    route, 4 lanes a thread) and on the cluster route forced on the same
    inputs."""
    _need_card()
    inp = _overlap_batch(case, np.random.default_rng(43))
    W = inp["doff"].shape[1]
    fin, _ = _ov_checked(inp, _ov_cluster_route(W) if route == "cluster"
                         else None)
    assert fin[: inp["meta"].shape[0]].all()


@pytest.mark.cuda
@pytest.mark.parametrize("gap_order", [0, 1])
@pytest.mark.parametrize("W", [1, 31, 33, 100, 203, 256, 257, 512, 513, 1100])
def test_ov_fill_routes_match_plain(W, gap_order):
    """K4 through the wrapper on random bands of W lanes: the warp route at
    its smallest lanes-a-thread up to the cutover, the cluster route past
    it (513 and 1100 lanes are always past it), each against the plain
    version."""
    _need_card()
    _ov_checked(random_ov_inputs(np.random.default_rng(61 + W), W,
                                 gap_order=gap_order))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gap0", "gap1"])
@pytest.mark.parametrize("lpt", fill_v2.WARP_LPTS)
def test_ov_warp_route_every_lanes_a_thread(lpt, case):
    """Each instantiation of the warp kernel, forced on a 31-lane band
    (which every lpt covers) and on the widest band it takes, against the
    plain version; and the cluster route forced on the same inputs."""
    _need_card()
    for W in (31, 32 * lpt):
        inp = random_ov_inputs(np.random.default_rng(7 * lpt + W), W,
                               gap_order=int(case == "gap1"))
        _ov_checked(inp, ("warp", lpt))
        _ov_checked(inp, _ov_cluster_route(W))


# the cluster routes' tilings: every one the route tables choose (with the
# widest band each takes), and tilings forced over 1, 2, 4 and 8 CTAs at
# every lanes-a-thread, two warps a CTA, on bands they fill exactly
def _table_tilings(route_fn, lo, hi):
    widest = {}
    for W in range(lo, hi + 1):
        widest[route_fn(W)[1]] = W
    return sorted((tiling, W) for tiling, W in widest.items())


def _forced_tilings(lpts):
    return [(nct, 2, lpt) for nct in (1, 2, 4, 8) for lpt in lpts]


def _ov_table_tilings():
    from quaff_tpu_torch.dp import ov_fill

    return _table_tilings(ov_fill.ov_route, ov_fill.OV_WARP_MAX_LANES + 1,
                          ov_fill.OV_LANE_CAP)


def _fill_table_tilings():
    return _table_tilings(fill_v2.fill_route, 32 * fill_v2.WARP_LPTS[-1] + 1,
                          fill_v2.FILL_CLUSTER_MAX_LANES)


def _tile_seams(W, tiling):
    """Strip seams on tile and CTA boundaries, the last strip ending at the
    band's last lane (the last CTA's last lane where the tiling fills W)."""
    nct, warps, lpt = tiling
    tile = 32 * lpt
    cta = warps * tile
    first = cta if nct > 1 else tile
    return sorted({0, min(first, W - 1), min(first + tile, W - 1), W})


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gap0", "gap1"])
@pytest.mark.parametrize("tiling, W", _ov_table_tilings(), ids=str)
def test_ov_cluster_table_tilings(tiling, W, case):
    """K4's cluster route at each tiling ov_route chooses, on the widest
    band it takes (random strips, and strips seamed on tile and CTA
    boundaries), against the plain version; a rerun is bit-identical."""
    _need_card()
    from quaff_tpu_torch.dp import ov_fill

    assert ov_fill.ov_route(W) == ("cluster", tiling)
    gap = int(case == "gap1")
    for seams in (None, _tile_seams(W, tiling)):
        inp = random_ov_inputs(np.random.default_rng(W + gap), W, B=4,
                               gap_order=gap, seams=seams)
        _, got = _ov_checked(inp)
        assert torch.equal(ov_fill.ov_fill(**inp), got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gap0", "gap1"])
@pytest.mark.parametrize("tiling", _forced_tilings((2, 4, 8)), ids=str)
def test_ov_cluster_forced_tilings(tiling, case):
    """K4's cluster route forced at 1, 2, 4 and 8 CTAs and every
    lanes-a-thread, on bands it fills exactly, strips seamed on tile and
    CTA boundaries and the last ending on a member lane at the last CTA's
    last lane; on full bands whose tiles are dead in most rows; and the
    warp route forced on the same inputs where one warp covers the band."""
    _need_card()
    nct, warps, lpt = tiling
    W = nct * warps * 32 * lpt
    gap = int(case == "gap1")
    rng = np.random.default_rng(W + 3 * lpt + gap)
    for inp in (random_ov_inputs(rng, W, B=4, gap_order=gap,
                                 seams=_tile_seams(W, tiling)),
                random_ov_inputs(rng, W, B=3, L=400, gap_order=gap,
                                 full=True)):
        _ov_checked(inp, ("cluster", tiling))
        if W <= 32 * fill_v2.WARP_LPTS[-1]:
            _ov_checked(inp, ("warp", fill_v2.fill_route(W)[1]))


@pytest.mark.cuda
def test_ov_cluster_refused_launch_raises():
    """A cluster of 16 CTAs (past the portable 8, which no route opts out
    of) is refused by the card: the entry returns an error, which the
    wrapper's launch check raises.  The wrapper itself takes no cluster of
    more than MAX_CLUSTER_CTAS, nor a tiling that cannot cover the band:
    it raises before any launch."""
    _need_card()
    from quaff_tpu_torch import kernels
    from quaff_tpu_torch.dp import ov_fill

    inp = random_ov_inputs(np.random.default_rng(5), 1024, B=2)
    B = inp["doff"].shape[0]
    before = ov_fill.ov_fill.launches
    out = torch.empty(B + B * inp["seg_start"].shape[1], device="cuda")
    err = kernels.library().quaff_ov_fill_cluster(
        *ov_fill.launch_args(**inp), 2, 16, 1, out.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="cluster route"):
        kernels.check_launch(err, "ov_fill", ("cluster", (16, 1, 2)), "")
    for bad in ((16, 1, 2), (1, 2, 2)):
        with pytest.raises(ValueError, match="no route"):
            ov_fill.ov_fill(**inp, route=("cluster", bad))
    assert ov_fill.ov_fill.launches == before
    # the card runs on: the table's route on the same inputs
    _ov_checked(inp, ov_fill.ov_route(1024))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["viterbi", "forward", "global"])
@pytest.mark.parametrize("tiling, W", _fill_table_tilings(), ids=str)
def test_fill_cluster_table_tilings(tiling, W, variant):
    """K1's cluster route at each tiling fill_route chooses, on the widest
    band it takes (local: random strips, and strips seamed on tile and CTA
    boundaries; global: one strip over every diagonal), against the plain
    version; a rerun is bit-identical."""
    _need_card()
    mode, local, qual, gap = FILL_VARIANTS[variant]
    assert fill_v2.fill_route(W) == ("cluster", tiling)
    tt = _tables("packed")
    for seams in ((None, _tile_seams(W, tiling)) if local else (None,)):
        inp, v2 = random_fill_inputs(np.random.default_rng(W), tt, W, B=4,
                                     local=local, qual=qual, seams=seams)
        got = _fill_checked(inp, v2, mode, local)
        assert torch.equal(
            fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local), got)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FILL_VARIANTS))
@pytest.mark.parametrize("tiling", _forced_tilings(fill_v2.FILL_CLUSTER_LPTS),
                         ids=str)
def test_fill_cluster_forced_tilings(tiling, variant):
    """K1's cluster route forced at 1, 2, 4 and 8 CTAs and every
    lanes-a-thread, on bands it fills exactly: local variants with strips
    seamed on tile and CTA boundaries (the last ending on a member lane at
    the last CTA's last lane), global ones over long reads whose tiles are
    dead in most rows; the block route forced on the same inputs."""
    _need_card()
    nct, warps, lpt = tiling
    W = nct * warps * 32 * lpt
    mode, local, qual, gap = FILL_VARIANTS[variant]
    tt = _tables("gaporder1" if gap else "packed")
    rng = np.random.default_rng(W + lpt)
    if local:
        inp, v2 = random_fill_inputs(rng, tt, W, B=4, qual=qual,
                                     seams=_tile_seams(W, tiling))
    else:
        inp, v2 = random_fill_inputs(rng, tt, W, B=3, Lx=W // 2 + 64,
                                     Ly=W // 4, local=False, qual=qual)
    _fill_checked(inp, v2, mode, local, ("cluster", tiling))
    _fill_checked(inp, v2, mode, local, ("block", 0))


@pytest.mark.cuda
def test_fill_cluster_refused_launch_raises():
    """K1's cluster route at 16 CTAs is refused by the card: the entry
    returns an error, which the wrapper's launch check raises.  The wrapper
    itself takes no cluster of more than MAX_CLUSTER_CTAS, nor a tiling
    that cannot cover the band: it raises before any launch."""
    _need_card()
    from quaff_tpu_torch import kernels

    inp, v2, mode, local = _variant_inputs("viterbi", 2048, 3)
    B = inp["doff"].shape[0]
    before = fill_v2.band_fill.launches
    out = torch.empty(B + B * inp["seg_start"].shape[1], device="cuda")
    err = kernels.library().quaff_band_fill_cluster(
        *fill_v2.launch_args(**inp, tables=v2, mode=mode, local=local),
        4, 16, 1, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err != 0
    with pytest.raises(RuntimeError, match="cluster route"):
        kernels.check_launch(err, "band_fill", ("cluster", (16, 1, 4)), "")
    for bad in ((16, 1, 4), (1, 2, 4)):
        with pytest.raises(ValueError, match="no route"):
            fill_v2.band_fill(**inp, tables=v2, route=("cluster", bad))
    assert fill_v2.band_fill.launches == before
    # the card runs on: the table's route on the same inputs
    _fill_checked(inp, v2, mode, local)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add_max", "roll_add", "lse_guarded",
                                "raw_lse", "raw_lse_log"])
def test_sol_chain_matches_plain(op):
    """The probes' chain kernel (csrc/sol_probe.cu) against chain_reference
    at 128 steps: add_max and roll_add bitwise (exact operations in the same
    order), the log-add-exp chains within rtol 1e-6 / atol 1e-5 (expf and
    log1pf of the card and PyTorch's kernels may differ by an ulp a step;
    the chain grows only like log(steps))."""
    _need_card()
    from quaff_tpu_torch.prof import chains, roofline_probe, sol_transcendental

    make = (roofline_probe.p1_inputs if op in ("add_max", "roll_add")
            else sol_transcendental.p2_inputs)
    a, b = make(64, 256, "cuda")
    before = chains.chain.launches[op]
    got = chains.chain(op, a, b, 2, 64)
    torch.cuda.synchronize()
    assert chains.chain.launches[op] == before + 1
    ref = chains.chain_reference(op, a, b, 2, 64)
    if op in ("add_max", "roll_add"):
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-5)
