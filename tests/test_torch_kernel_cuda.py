"""The port's CUDA kernels against their plain PyTorch versions on the
card, on identical inputs: K1 (quaff_tpu_torch/csrc/band_fill.cu, its warp
route at every lanes-a-thread instantiation, its cluster and smem routes
at every tiling their route tables choose and at forced ones, the smem
route's seams against one warp a pair, its shared and global tiers against
each other, and its global tier past the shared tier, on global
long-deletion bands up to 262144 lanes),
K2 and K3 (csrc/estep.cu, csrc/estep_cluster.cu, csrc/estep_smem.cu:
their warp routes at every lanes-a-thread instantiation, their cluster
routes at the tilings their route tables choose up to 2048 lanes and at
each table row's widest band, at forced tilings and against their own
one-tile tiling, the two-level fold past 32 tiles and forced on a few,
their smem routes' shared and global tiers at every table row and past
it, against a one-tile run and against each other, on global
long-deletion bands up to 262144 lanes, and each pairing of a K2 route
with a K3 route), the count
reduction (bit for bit), K4 (csrc/ov_fill.cu: its warp route at every
lanes-a-thread instantiation, its cluster route as K1's) and the probes'
chain kernel (csrc/sol_probe.cu).  Needs an NVIDIA GPU and skips without
one.  This file imports no JAX, so it also runs on a host that has none:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernel_cuda.py

(`-k cluster` selects the cluster routes' tests, `-k two_level` the
two-level fold's, `-k smem` the smem routes' of K1, K2 and K3, `-k
fill_smem` K1's alone, `-k estep_smem` K2's and K3's shared and global
tiers.)

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
from quaff_tpu_torch.envelope import Envelope, full_envelope, sparse_envelope
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
        # a full envelope of 10370 lanes, past the train path's widest
        # band: K1's cluster route, K2's and K3's smem and two-level
        # cluster routes (the width at which the former block route first
        # kept its row in global scratch)
        xs = "".join("ACGT"[t] for t in rng.integers(0, 4, 10169))
        x = FastSeq(name="x", seq=xs)
        y = FastSeq(name="y", seq=xs[1000:1200], qual="5" * 200)
        pb = PairBatch.build([(x, y, full_envelope(len(xs), 200))] * 2, tt)
        assert pb.member.shape[1] > estep.ESTEP_WIDE_LANES
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
               "smem_launches", "global_launches")


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
                                                    "smem", "global")]
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode,
                                      local=local)
    _assert_scores_close(got, ref, inp["doff"].shape[0])
    return got


def _fill_global(W):
    """K1's smem route's global tier at its own tiling for a band of W
    lanes (global_tiling): a route K1 has at any width."""
    return "global", fill_v2.global_tiling(W, fill_v2.FILL_GLOBAL_WARPS)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FILL_VARIANTS))
@pytest.mark.parametrize("W", [1, 31, 33, 100, 203, 512, 513])
def test_fill_routes_match_plain(W, variant):
    """K1 through the wrapper on random bands of W lanes: the warp route at
    its smallest lanes-a-thread (W = 1 and 31: 1, 33: 2, 100: 4, 203: 8,
    512: 16), the cluster route at 513, each against band_fill_reference;
    at 513 the smem route's global tier forced on the same inputs too."""
    _need_card()
    inp, v2, mode, local = _variant_inputs(variant, W, 41 + W)
    _fill_checked(inp, v2, mode, local)
    if W > 32 * fill_v2.WARP_LPTS[-1]:
        _fill_checked(inp, v2, mode, local, _fill_global(W))


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


def _estep_plain(variant, W, seed, **kw):
    """K2's and K3's inputs on random bands of W lanes (random_fill_inputs,
    with `kw`) and their plain versions' outputs (_plain_case)."""
    local, tables = ESTEP_VARIANTS[variant]
    inp, v2 = random_fill_inputs(np.random.default_rng(seed), _tables(tables),
                                 W, local=local, **kw)
    return _plain_case(inp, v2, local)


def _plain_case(inp, v2, local, exact=False):
    """(inp, v2, local, fwd_p, wrow, part_p, sc_p, fwd32): the plain
    versions' outputs on K2's and K3's inputs; wrow's weights are 0.5 and
    its normalisers the plain forward scores, or with `exact` the float64
    forward fill's (band_fill_reference in float64), which fwd_p then
    holds, and fwd32 the plain version's forward scores (else None).  With
    float32 cells the plain forward fill drifted 2e-2 to 5e-2 nats off the
    float64 one past 16384 lanes on global long-deletion bands, too far to
    normalise the back-start posterior by; its wide arithmetic (float64
    cells past ESTEP_WIDE_LANES) holds it within 5e-3, and the float64
    fill stays the yardstick."""
    fwd_p, rows_p, offs_p = estep.fwd_store_reference(**inp, tables=v2,
                                                      local=local)
    fwd32 = None
    if exact:
        B = fwd_p.shape[0]
        fwd32, fwd_p = fwd_p, fill_v2.band_fill_reference(
            **inp, tables=v2, mode="forward", local=local,
            dtype=torch.float64)[:B]
    fin = fwd_p > fill_v2.NEG_INF / 2
    wrow = torch.stack([torch.full_like(fwd_p, 0.5),
                        torch.where(fin, fwd_p, 0.0)]).float().contiguous()
    part_p, sc_p = estep.bwd_counts_reference(
        inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow,
        rows_p, offs_p, local=local)
    return inp, v2, local, fwd_p, wrow, part_p, sc_p, fwd32


def _estep_routes_check(inp, v2, local, fwd_p, wrow, part_p, sc_p, fwd32,
                        routes):
    """Each (K2 route, K3 route) pair against the plain versions: forward
    scores rtol 1e-5 / atol 1e-3, tables and d_sc rtol 3e-3 / atol 5e-3,
    the back-start posterior of every finite pair within 5e-3 of 1, both
    kernels bit-identical on a second run, one launch counted on each
    kernel's route.  K3 runs on the kernel K2's store with wrow, whose
    normalisers are the plain forward scores, as the JAX package's test
    runs its kernels (tests/test_pallas_counts.py): the back-start
    posterior then also holds K2's forward scores to the plain version's
    within about 5e-3 nats.  In an exact case (fwd32, the plain float32
    forward scores, given by _plain_case(..., exact=True)) fwd_p and the
    normalisers are the float64 forward fill's, the back-start posterior
    is held to 1 alone, not to the plain K3's (whose float32 backward fill
    drifts with its forward fill there), and the other per-pair sums and
    the tables to the plain K3's.  The E-step itself divides by K2's own
    forward score, so there K2's forward score is held to the float64
    fill's: each pair's within 5e-3 nats of it, and the back-start
    posterior on K2's own forward score, exp(K3's backward total - K2's
    forward score) (what the E-step's posterior reads), within 5e-3 of
    1; both are printed beside the plain version's forward drift."""
    kinds = ESTEP_KINDS
    counts = ("launches",) + tuple(f"{k}_launches" for k in kinds)
    exact = fwd32 is not None
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
        assert moved == [1] + [int(r2[0] == k) for k in kinds]
        assert torch.equal(fwd > fill_v2.NEG_INF / 2, fin)
        np.testing.assert_allclose(fwd[fin].double().cpu(),
                                   fwd_p[fin].double().cpu(),
                                   rtol=1e-5, atol=1e-3)
        before = [getattr(estep.bwd_counts, k) for k in counts]
        part, sc = estep.bwd_counts(*base, rows, offs, local=local, route=r3)
        torch.cuda.synchronize()
        moved = [getattr(estep.bwd_counts, k) - n
                 for k, n in zip(counts, before)]
        assert moved == [1] + [int(r3[0] == k) for k in kinds]
        for got, want in ((part, part_p), (sc[:4] if exact else sc,
                                           sc_p[:4] if exact else sc_p)):
            np.testing.assert_allclose(got.double().cpu(),
                                       want.double().cpu(),
                                       rtol=3e-3, atol=5e-3)
        bsp = sc[4][fin].double().cpu()
        assert float((bsp - 1).abs().max()) < 5e-3
        if exact:
            f64 = fwd_p[fin].double().cpu()
            k2_off = fwd[fin].double().cpu() - f64
            plain_off = fwd32[fin].double().cpu() - f64
            # exp(back - fwd) = exp(back - f64) * exp(f64 - fwd); K3's
            # own error takes out exp(f64 - fnorm), the rounding of its
            # float32 normaliser (up to 2e-3 nats at these scores)
            own = bsp * torch.exp(-k2_off)
            k3_own = bsp / torch.exp(f64 - wrow[1][fin].double().cpu())
            print(f"exact W={inp['doff'].shape[1]} K2 {r2} K3 {r3}: K2's "
                  f"forward - float64 fill {float(k2_off.abs().max()):.3g} "
                  f"nats (plain float32 "
                  f"{float(plain_off.abs().max()):.3g}); back-start "
                  f"posterior on K2's own forward within "
                  f"{float((own - 1).abs().max()):.3g} of 1, on the float64 "
                  f"fill's {float((bsp - 1).abs().max()):.3g}; K3's "
                  f"backward total off the float64 fill's "
                  f"{float((k3_own - 1).abs().max()):.3g}")
            assert float(k2_off.abs().max()) < 5e-3
            assert float((own - 1).abs().max()) < 5e-3
        fwd2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local,
                                             route=r2)
        part2, sc2 = estep.bwd_counts(*base, rows2, offs2, local=local,
                                      route=r3)
        assert torch.equal(fwd, fwd2)
        assert torch.equal(part, part2) and torch.equal(sc, sc2)


# the route kinds of K2 and K3, each with its launch count
ESTEP_KINDS = ("warp", "cluster", "smem", "global")

# each kernel's cutover and the width past it, and 1536 and 2048 lanes
# (the 48 KB of shared memory the former block routes' row state took)
ESTEP_WIDTHS = sorted({3, 32, 33, 168, 256, 1536, 2048}.union(
    *({c, c + 1} for c in estep.ESTEP_WARP_MAX_LANES.values())))


def _global(W):
    """The smem routes' global tier at its own tiling for a band of W
    lanes: a route of both kernels at any width."""
    return "global", fill_v2.global_tiling(W, estep.ESTEP_GLOBAL_WARPS)


def _kernel_routes(W, kernel):
    """The routes of K2 or K3 held against each other on a band of W lanes:
    the warp route at the smallest lanes-a-thread that covers W (up to 512
    lanes), the cluster route at the table's tiling (up to the kernel's
    ESTEP_CLUSTER_MAX_LANES) or else the smem route's shared tier at its
    table's (up to ESTEP_SMEM_MAX_LANES[kernel]), the global tier."""
    routes = [_global(W)]
    if W <= estep.ESTEP_CLUSTER_MAX_LANES[kernel]:
        routes.insert(0, ("cluster", fill_v2.cluster_tiling(
            W, estep.ESTEP_CLUSTER_TABLE[kernel])))
    elif W <= estep.ESTEP_SMEM_MAX_LANES[kernel]:
        routes.insert(0, ("smem", fill_v2.cluster_tiling(
            W, estep.ESTEP_SMEM_TABLE[kernel])))
    if estep.warp_lpt(W) is not None:
        routes.insert(0, ("warp", estep.warp_lpt(W)))
    return routes


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(ESTEP_VARIANTS))
@pytest.mark.parametrize("W", ESTEP_WIDTHS)
def test_estep_routes_match_plain(W, variant):
    """K2 and K3 on random bands of W lanes (their strips end on member
    lanes, not on halo lanes), each route forced and each pairing of a K2
    route with a K3 route (the layout they share), against
    fwd_store_reference and bwd_counts_reference: the warp route at the
    smallest lanes-a-thread that covers W (up to 512 lanes), the cluster
    route at each kernel's table tiling and the smem routes' global tier;
    then both kernels through estep_route's own route."""
    _need_card()
    case = _estep_plain(variant, W, 61 + W)
    pairs = [(r2, r3) for r2 in _kernel_routes(W, "fwd_store")
             for r3 in _kernel_routes(W, "bwd_counts")]
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
    dead in most rows; the smem route's global tier forced on the same
    inputs."""
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
    _fill_checked(inp, v2, mode, local, _fill_global(W))


def _stored_rows_check(inp, v2, local, rows, offs):
    """K2's stored rows on the card against the plain version's, up to each
    pair's read length: the same cells hold NEG, the others' absolute
    values (cell + the row's offset) within K1's rtol 1e-5 / atol 1e-3 of
    the plain version's, and each row's largest cell is 0 (past
    ESTEP_WIDE_LANES its largest match or insert cell)."""
    wide = inp["doff"].shape[1] > estep.ESTEP_WIDE_LANES
    _, rows_p, offs_p = estep.fwd_store_reference(**inp, tables=v2,
                                                  local=local)
    floor = fill_v2.NEG_INF / 2
    for b, n in enumerate(inp["meta"][:, 1].tolist()):
        got, want = rows[:, b, :n].cpu(), rows_p[:, b, :n].cpu()
        live = want > floor
        assert torch.equal(got > floor, live)
        if not bool(live.any()):
            continue
        a = got.double() + offs[b, :n].cpu()[None, :, None]
        w = want.double() + offs_p[b, :n].cpu()[None, :, None]
        np.testing.assert_allclose(a[live], w[live], rtol=1e-5, atol=1e-3)
        n_top = 2 if wide else 3
        top = torch.where(live[:n_top], got[:n_top],
                          float("-inf")).amax(dim=(0, 2))
        assert bool((top[live[:n_top].any(0).any(-1)] == 0).all())


def _estep_table_tilings(kernel):
    """(kernel, tiling, W): each tiling estep_route chooses for the kernel
    past its warp route up to 2048 lanes, with the widest band it takes
    there, and at each row of the kernel's ESTEP_CLUSTER_TABLE the row's
    widest band."""
    widest = {}
    for W in range(estep.ESTEP_WARP_MAX_LANES[kernel] + 1, 2049):
        widest[estep.estep_route(W, kernel)[1]] = W
    for W, _, _ in estep.ESTEP_CLUSTER_TABLE[kernel]:
        widest[estep.estep_route(W, kernel)[1]] = W
    return [(kernel, t, W) for t, W in sorted(widest.items())]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["local", "global"])
@pytest.mark.parametrize(
    "kernel, tiling, W",
    _estep_table_tilings("fwd_store") + _estep_table_tilings("bwd_counts"),
    ids=str)
def test_estep_cluster_table_tilings(kernel, tiling, W, variant):
    """K2's or K3's cluster route at each tiling estep_route chooses, on the
    widest band it takes (random strips over a ref as wide as the band, or
    one strip over every diagonal of a read and a ref twice its length, as
    in the forced tilings), the other kernel on its own route, against the
    plain versions; K2's stored rows against the plain version's; each
    kernel rerun bit for bit."""
    _need_card()
    assert estep.estep_route(W, kernel) == ("cluster", tiling)
    if variant == "local":
        kw = dict(Lx=W + 64, Ly=120)
    else:
        kw = dict(Lx=W // 2 + 64, Ly=min(W // 4, 1024))
    # global bands past ESTEP_WIDE_LANES take the float64 normaliser
    exact = variant == "global" and W > estep.ESTEP_WIDE_LANES
    local, tables = ESTEP_VARIANTS[variant]
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 7),
                                 _tables(tables), W, B=4, local=local, **kw)
    case = _plain_case(inp, v2, local, exact=exact)
    r = ("cluster", tiling)
    if kernel == "fwd_store":
        pair = (r, estep.estep_route(W, "bwd_counts"))
    else:
        pair = (estep.estep_route(W, "fwd_store"), r)
    _estep_routes_check(*case, [pair])
    _stored_rows_check(inp, v2, local, *estep.fwd_store(
        **inp, tables=v2, local=local, route=pair[0])[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4097, 8192, 16384])
def test_estep_block_routes_past_the_cluster_routes(W):
    """The smem routes' global tier (the route that took the former block
    routes' bands) forced on global bands of reads of up to 1024 rows over
    refs of up to W / 2 + 64 bases, about 3300 deletions a read, where K2's
    shared tier and K3's cluster route are estep_route's, against the
    plain versions (normalised by the float64 forward fill, _plain_case's
    exact): the back-start posterior within 5e-3 of 1, K2's forward score
    within 5e-3 nats of the float64 fill; K2's stored rows against the
    plain version's.  K3's global tier runs float64 cells here too (its
    kernel's arithmetic at any width)."""
    _need_card()
    routes = tuple(estep.estep_route(W, k) for k in ("fwd_store",
                                                      "bwd_counts"))
    assert [r[0] for r in routes] == ["smem", "cluster"]
    local, tables = ESTEP_VARIANTS["global"]
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 7),
                                 _tables(tables), W, B=4, local=local,
                                 Lx=W // 2 + 64, Ly=min(W // 4, 1024))
    case = _plain_case(inp, v2, local, exact=True)
    routes = (_global(W), _global(W))
    _estep_routes_check(*case, [routes, (routes[0], estep.estep_route(
        W, "bwd_counts"))])
    _stored_rows_check(inp, v2, local, *estep.fwd_store(
        **inp, tables=v2, local=local, route=routes[0])[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["local", "global"])
def test_estep_block_routes_past_the_widest_band(variant):
    """One lane past the widest band either kernel's shared tier takes
    (ESTEP_SMEM_MAX_LANES) both kernels take the smem routes' global tier,
    each thread's run in a per-pair slab of global memory, and a cluster
    tiling or a shared-tier tiling whose run does not fit a CTA is refused
    before any launch: on random strips over a ref as wide as the band,
    against the plain versions; on the global long-deletion recipe (reads
    of up to 1024 rows over refs of W / 2 + 64 bases), with the float64
    forward fill as the normaliser (_plain_case's exact)."""
    _need_card()
    W = max(estep.ESTEP_SMEM_MAX_LANES.values()) + 1
    routes = tuple(estep.estep_route(W, k) for k in ("fwd_store",
                                                      "bwd_counts"))
    assert routes == (_global(W), _global(W))
    local = variant == "local"
    kw = (dict(Lx=W + 64, Ly=120) if local
          else dict(Lx=W // 2 + 64, Ly=1024))
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 7),
                                 _tables("packed"), W, B=4, local=local, **kw)
    for kind, tiling in (("cluster", (16, 8, 32)), ("cluster", (16, 16, 16)),
                         ("smem", (16, 16, 16)), ("smem", (16, 16, 17))):
        assert W <= 32 * tiling[2] * tiling[1] * tiling[0]
        with pytest.raises(ValueError, match="no route"):
            estep.fwd_store(**inp, tables=v2, local=local,
                            route=(kind, tiling))
    _estep_routes_check(*_plain_case(inp, v2, local, exact=not local),
                        [routes])
    _stored_rows_check(inp, v2, local, *estep.fwd_store(
        **inp, tables=v2, local=local)[1:])


# phase 4b's count -fast -kmatchoff chunk's width, the widest band of K3's
# two-level tilings, the smem routes' first band, phase 4b's 34 kb count's
# width, 65536 lanes and each kernel's widest shared-tier band
TWO_LEVEL_WIDTHS = (22136, estep.ESTEP_CLUSTER_MAX_LANES["bwd_counts"],
                    estep.ESTEP_CLUSTER_MAX_LANES["bwd_counts"] + 1, 35506,
                    65536, *sorted(estep.ESTEP_SMEM_MAX_LANES.values()))


def _fold_count(route):
    """The launch count a two-level route moves: two_level_launches for a
    cluster route, smem_launches or global_launches for an smem route."""
    if route[0] == "cluster":
        return "two_level_launches"
    return f"{route[0]}_launches"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["local", "global"])
@pytest.mark.parametrize("W", TWO_LEVEL_WIDTHS)
def test_estep_two_level_fold_matches_plain(W, variant):
    """K2's and K3's routes that fold in two levels (more than 32 tiles:
    each CTA folds its warps' tiles, then the CTAs fold): K3's two-level
    cluster route up to 32768 lanes, both kernels' smem routes (each
    thread's lanes in shared memory, or past the kernel's shared tier in
    global memory; K2's cells float64, K3's past ESTEP_BWD_F64_LANES) past
    their cluster routes, at phase 4b's widths, the smem routes' first band
    and each kernel's widest shared-tier band, each paired with itself and
    with the other kernel's global tier at its own tiling (the layout they
    share), against the plain versions (K3 normalised by the plain forward
    scores): local, random strips over a ref as wide as the band and
    strips seamed on tile and CTA boundaries; global, one strip over every
    diagonal of reads of up to 1024 rows and refs of W / 2 + 64 bases,
    normalised by the float64 forward fill (_plain_case's exact), K2's
    forward score within 5e-3 nats of it.  K2's stored rows against the
    plain version's; both kernels bit for bit on a rerun; each launch
    counted on its fold."""
    _need_card()
    r2, r3 = (estep.estep_route(W, k) for k in ("fwd_store", "bwd_counts"))
    for r in (r2, r3):
        nct, warps, lpt = r[1]
        assert nct * warps > fill_v2.MAX_TILES and nct > 1
        if r[0] == "cluster":
            assert estep.cluster_mode(W, r[1]) == estep.TWO_FOLD
        else:
            assert r[0] in ("smem", "global")
    assert r2[0] in ("smem", "global")
    if variant == "local":
        kws = [dict(Lx=W + 64, Ly=120),
               dict(Lx=W + 64, Ly=120, seams=_tile_seams(W, r2[1]))]
    else:
        kws = [dict(Lx=W // 2 + 64, Ly=min(W // 4, 1024))]
    gl = _global(W)
    exact = variant == "global"
    for kw in kws:
        local, tables = ESTEP_VARIANTS[variant]
        inp, v2 = random_fill_inputs(np.random.default_rng(W + 11),
                                     _tables(tables), W, B=3, local=local,
                                     **kw)
        case = _plain_case(inp, v2, local, exact=exact)
        pairs = list(dict.fromkeys([(r2, r3), (r2, gl), (gl, r3)]))
        before = [getattr(estep.fwd_store, _fold_count(r2)),
                  getattr(estep.bwd_counts, _fold_count(r3))]
        _estep_routes_check(*case, pairs)
        # each pairing runs each kernel twice on its route
        n2 = 2 * sum(_fold_count(q[0]) == _fold_count(r2) for q in pairs)
        n3 = 2 * sum(_fold_count(q[1]) == _fold_count(r3) for q in pairs)
        assert [getattr(estep.fwd_store, _fold_count(r2)),
                getattr(estep.bwd_counts, _fold_count(r3))] == [
            before[0] + n2, before[1] + n3]
        inp, v2, local = case[:3]
        _stored_rows_check(inp, v2, local, *estep.fwd_store(
            **inp, tables=v2, local=local, route=r2)[1:])


# the widths at which K2's float32 forward score was measured off the
# float64 fill on the global long-deletion recipe (ROADMAP queue 3 item
# 1), phase 4b's 34 kb width, 65536 lanes, the global tier at 131072 and
# 262144 lanes (B=2 there: a [3, B, 1024, W] float32 store is 3.2 GB a
# pair)
LONG_DELETION_WIDTHS = (8192, 16384, 22136, 24576, 24577, 28672, 32768, 32769,
                        35506, 65536, 131072, 262144)


@pytest.mark.cuda
@pytest.mark.parametrize("W", LONG_DELETION_WIDTHS)
def test_estep_two_level_long_deletions(W):
    """K2's and K3's routes on the global long-deletion input (reads of up
    to 1024 rows over refs of W / 2 + 64 bases, up to ~130000 deletions a
    read) at LONG_DELETION_WIDTHS: K2's smem route, K3's two-level cluster
    route up to 32768 lanes and its smem route past it (float64 cells),
    each kernel's shared tier up to its widest band and the global tier
    past it: both routed kernels and both global tiers forced, the
    back-start posterior, with the float64 forward fill as the normaliser,
    within 5e-3 of 1, K2's forward score within 5e-3 nats of the float64
    fill's and the back-start posterior on K2's own forward score within
    5e-3 of 1 (with float32 cells K2 was up to 3.7e-2 nats off here), the
    tables and the other per-pair sums against the plain versions; K3's
    posterior error printed (-rP)."""
    _need_card()
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 7),
                                 _tables("packed"), W,
                                 B=4 if W <= 65536 else 2,
                                 Lx=W // 2 + 64, Ly=1024, local=False)
    routes = tuple(estep.estep_route(W, k) for k in ("fwd_store",
                                                      "bwd_counts"))
    assert routes[0][0] in ("smem", "global")
    assert routes[1][0] in ("smem", "global") or estep.cluster_mode(
        W, routes[1][1]) == estep.TWO_FOLD
    _estep_routes_check(*_plain_case(inp, v2, False, exact=True),
                        list(dict.fromkeys([routes, (_global(W),) * 2])))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(ESTEP_VARIANTS))
@pytest.mark.parametrize("tiling", [
    (nct, warps if nct * warps * 32 * lpt
     <= estep.ESTEP_CLUSTER_MAX_LANES["bwd_counts"] else 1, lpt)
    for nct, warps, lpt in _forced_tilings(estep.ESTEP_CLUSTER_LPTS)],
    ids=str)
def test_estep_cluster_forced_tilings(tiling, variant):
    """K2's and K3's cluster routes forced at 1, 2, 4 and 8 CTAs and every
    lanes-a-thread, two warps a CTA (one where two would fill more than
    K3's ESTEP_CLUSTER_MAX_LANES, the widest band its route takes; K2's
    smem route at the tiling where its cluster route has no fold for it,
    past 4096 lanes), on bands they fill exactly: local
    variants with strips seamed on tile and CTA boundaries (the last ending
    on a member lane at the last CTA's last lane), global ones over long
    reads whose tiles are dead in most rows; each paired with itself and
    with the other kernel's smem route's global tier at the same tiling,
    against the plain versions (global bands past ESTEP_WIDE_LANES with the
    float64 forward fill as K3's normaliser, _plain_case's exact); K2's
    stored rows against the plain version's."""
    _need_card()
    nct, warps, lpt = tiling
    W = nct * warps * 32 * lpt
    local, tables = ESTEP_VARIANTS[variant]
    rng = np.random.default_rng(W + lpt + 1)
    if local:
        inp, v2 = random_fill_inputs(rng, _tables(tables), W, B=4,
                                     seams=_tile_seams(W, tiling))
    else:
        inp, v2 = random_fill_inputs(rng, _tables(tables), W, B=3,
                                     Lx=W // 2 + 64, Ly=min(W // 4, 1024),
                                     local=False)
    cl, gl = ("cluster", tiling), ("global", tiling)
    c2 = cl if estep.estep_route_ok(W, cl, "fwd_store") else ("smem", tiling)
    # global bands past ESTEP_WIDE_LANES take the float64 normaliser: on
    # (8, 2, 16)'s gap-order-1 band the float32-cell forward fill was
    # 9.3e-3 off it
    exact = not local and W > estep.ESTEP_WIDE_LANES
    _estep_routes_check(*_plain_case(inp, v2, local, exact=exact),
                        [(c2, cl), (c2, gl), (gl, cl)])
    _stored_rows_check(inp, v2, local, *estep.fwd_store(
        **inp, tables=v2, local=local, route=c2)[1:])


def _seam_pairs(rng, lanes, ylen=100, W=512):
    """Pairs of a random ref and a read copied from it (8% substitutions,
    qualities), in full envelopes of W lanes: pair i's alignment diagonal
    lies on band lane lanes[i] (PairBatch.build puts a halo lane first),
    so that most of its posterior mass sits on the lanes around it."""
    pairs = []
    xlen = W - ylen - 1
    for i, lane in enumerate(lanes):
        d = lane - ylen
        assert 0 <= d <= xlen - ylen
        xs = "".join("ACGT"[t] for t in rng.integers(0, 4, xlen))
        ys = list(xs[d:d + ylen])
        for k in range(ylen):
            if rng.random() < 0.08:
                ys[k] = "ACGT"[int(rng.integers(0, 4))]
        q = "".join(chr(33 + int(v)) for v in rng.integers(3, 40, ylen))
        pairs.append((FastSeq(name=f"x{i}", seq=xs),
                      FastSeq(name=f"y{i}", seq="".join(ys), qual=q),
                      full_envelope(xlen, ylen)))
    pb = PairBatch.build(pairs, _tables("packed"))
    assert pb.member.shape[1] == W
    return pb


@pytest.mark.cuda
@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("tiling", [(1, 4, 4), (2, 2, 4), (4, 1, 4),
                                    (1, 2, 8), (2, 1, 8)], ids=str)
def test_estep_cluster_seams_match_one_tile(tiling, local):
    """K2's and K3's cluster routes over several tiles and CTAs against
    their own one-tile run (1 x 1 x 16: no seam) on the same 512-lane band,
    pairs whose alignment diagonals lie on tile boundaries: every seam's
    value (the next tile's first cells, the delete value entering a tile,
    the previous tile's insert cell, the edge lanes' stored cells, the row
    shift) is then on the path, and a wrong one moves the forward scores
    by nats and K3's tables by 1e-4 to 1 of their largest entry (measured
    on a CPU host with one of each broken), while a right one changes only
    the order of float32 sums (1e-4 nats of a forward score, 1e-7 of a
    table, 4e-6 of the per-pair sums).  Held at forward scores 1e-3,
    stored rows' absolute cells 1e-2, tables 1e-5 and per-pair sums 3e-5
    of their largest: far inside the plain versions' rtol 3e-3, which a
    wrong seam on random strips passes."""
    _need_card()
    rng = np.random.default_rng(17)
    pb = _seam_pairs(rng, [127, 128, 255, 256, 383, 384])
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(_tables("packed"), "cuda")
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)
    one, many = ("cluster", (1, 1, 16)), ("cluster", tiling)
    f1, rows1, offs1 = estep.fwd_store(**inp, tables=v2, local=local,
                                       route=one)
    f2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local,
                                       route=many)
    fin = f1 > fill_v2.NEG_INF / 2
    assert bool(fin.all()) and torch.equal(f2 > fill_v2.NEG_INF / 2, fin)
    assert float((f1 - f2).abs().max()) <= 1e-3
    live = rows1 > fill_v2.NEG_INF / 2
    assert torch.equal(rows2 > fill_v2.NEG_INF / 2, live)
    a1 = rows1.double() + offs1[None, :, :, None]
    a2 = rows2.double() + offs2[None, :, :, None]
    assert float((a1 - a2).abs()[live].max()) <= 1e-2
    wrow = torch.stack([torch.full_like(f1, 0.5), f1]).contiguous()
    p1, s1 = estep.bwd_counts(*base, wrow, rows1, offs1, local=local,
                              route=one)
    p2, s2 = estep.bwd_counts(*base, wrow, rows1, offs1, local=local,
                              route=many)
    assert float((p1 - p2).abs().max()) <= 1e-5 * float(p1.abs().max())
    assert float((s1 - s2).abs().max()) <= 3e-5 * float(s1.abs().max())


def _two_level_seam_lanes(W, tiling, ylen=100):
    """The band lanes of _seam_pairs' paths for `tiling` on a band of W
    lanes: either side of its first tile boundary and of each boundary
    between CTAs that hold lanes, within the lanes a read of ylen rows can
    start on."""
    nct, warps, lpt = tiling
    tile, cta = 32 * lpt, 32 * lpt * warps
    lanes = {tile - 1, tile}
    for c in range(1, nct):
        if c * cta < W - ylen:
            lanes |= {c * cta - 1, c * cta}
    return sorted(v for v in lanes if ylen <= v <= W - 2 * ylen - 1)


def _seams_check(inp, v2, local, kernel_routes, k3=True):
    """K2 and K3 on kernel_routes {kernel: (folded route, route without
    its seams)} on the same inputs, at the bounds of
    test_estep_cluster_seams_match_one_tile: forward scores 1e-3, stored
    rows' absolute cells 1e-2, with k3 K3's tables 1e-5 and per-pair sums
    3e-5 of their largest (K3 on the seamless K2 route's store); each
    folded launch counted on its fold."""
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)
    two, ref = kernel_routes["fwd_store"]
    f1, rows1, offs1 = estep.fwd_store(**inp, tables=v2, local=local,
                                       route=ref)
    n = getattr(estep.fwd_store, _fold_count(two))
    f2, rows2, offs2 = estep.fwd_store(**inp, tables=v2, local=local,
                                       route=two)
    assert getattr(estep.fwd_store, _fold_count(two)) == n + 1
    fin = f1 > fill_v2.NEG_INF / 2
    assert bool(fin.all()) and torch.equal(f2 > fill_v2.NEG_INF / 2, fin)
    assert float((f1 - f2).abs().max()) <= 1e-3
    live = rows1 > fill_v2.NEG_INF / 2
    assert torch.equal(rows2 > fill_v2.NEG_INF / 2, live)
    a1 = rows1.double() + offs1[None, :, :, None]
    a2 = rows2.double() + offs2[None, :, :, None]
    assert float((a1 - a2).abs()[live].max()) <= 1e-2
    if not k3:
        return
    two, ref = kernel_routes["bwd_counts"]
    wrow = torch.stack([torch.full_like(f1, 0.5), f1]).contiguous()
    p1, s1 = estep.bwd_counts(*base, wrow, rows1, offs1, local=local,
                              route=ref)
    n = getattr(estep.bwd_counts, _fold_count(two))
    p2, s2 = estep.bwd_counts(*base, wrow, rows1, offs1, local=local,
                              route=two)
    assert getattr(estep.bwd_counts, _fold_count(two)) == n + 1
    print(f"seams {kernel_routes}: K3 tables "
          f"{float((p1 - p2).abs().max()) / float(p1.abs().max()):.3g}, "
          f"sums {float((s1 - s2).abs().max()) / float(s1.abs().max()):.3g}"
          " of their largest")
    assert float((p1 - p2).abs().max()) <= 1e-5 * float(p1.abs().max())
    assert float((s1 - s2).abs().max()) <= 3e-5 * float(s1.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("tiling", [(5, 7, 4), (6, 6, 4), (9, 4, 4),
                                    (8, 5, 4), (16, 3, 4), (5, 7, 8)],
                         ids=str)
def test_estep_two_level_seams_match_one_fold(tiling, local):
    """K3's two-level fold and K2's smem route (more than 32 tiles: each
    CTA folds its warps' tiles, then the CTAs fold), up to 16 CTAs, 4 and
    8 lanes a thread, some CTAs past the band, on bands of reads copied
    from their refs (_seam_pairs) whose alignment diagonals lie either
    side of its tile and CTA boundaries, against a route without its
    seams on the same inputs (_seams_check's bounds): a wrong first-level
    prefix, a lost seam between CTAs, a wrong composite of the tiles after
    a tile or a lost insert cell from the previous CTA each moved the
    forward scores past 1e-3 or the tables past 1e-5 (measured on a CPU
    host with one of each broken), while a right fold changes only the
    order of the sums.  K2 against one tile of the smem routes' global
    tier (one warp, every lane of the band in its 32 threads' runs: no tile
    or CTA seam), in the same float64 arithmetic.  K3: local, 4096 lanes, against the one-fold table tiling
    (8 x 4 x 4, whose own seams test_estep_cluster_seams_match_one_tile
    holds to the one-tile run); global, 4480 lanes (every path crosses
    every seam; ~4300 deletions a read), held by the exact tests alone,
    since on these bands any two right routes' tables (the former block
    route, six two-level tilings) differ by up to 1.8e-5 of their largest entry,
    the order of float32 sums over the deletion chains (measured on the
    card), past the bound that tells a right fold from a wrong one."""
    _need_card()
    W = estep.ESTEP_WIDE_LANES if local else 4480
    nct, warps, lpt = tiling
    assert nct * warps > fill_v2.MAX_TILES and W <= nct * warps * 32 * lpt
    assert estep.cluster_mode(W, tiling) == estep.TWO_FOLD
    ref = estep.estep_route(W, "bwd_counts")
    if local:
        assert ref == ("cluster", (8, 4, 4))
        assert estep.cluster_mode(W, ref[1]) == estep.ONE_FOLD
    lanes = _two_level_seam_lanes(W, tiling)
    assert len(lanes) >= 4
    pb = _seam_pairs(np.random.default_rng(17), lanes, W=W)
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(_tables("packed"), "cuda")
    _seams_check(inp, v2, local, {
        "fwd_store": (("smem", tiling), _one_tile(W)),
        "bwd_counts": (("cluster", tiling), ref)}, k3=local)


def _one_tile(W):
    """The smem routes' global tier as one warp over a band of W lanes (any
    lanes a thread): a route without tile or CTA seams."""
    return "global", (1, 1, -(-W // 32))


@pytest.mark.cuda
@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("W, tiling", [(35506, (14, 16, 5)),
                                       (35506, (9, 16, 8)),
                                       (65536, (16, 16, 8))], ids=str)
def test_estep_smem_seams_match_the_block_route(W, tiling, local):
    """K2's and K3's smem routes past 32768 lanes (the table's tilings at
    phase 4b's 34 kb width and at 65536 lanes, and one of 9 CTAs of 8
    lanes a thread): each thread's run of lanes in shared memory, its
    tiles folded in its CTA, the CTAs at the cluster barrier, on bands of
    reads copied from their refs whose alignment diagonals lie either side
    of a tile boundary and of every CTA boundary, against one tile of the
    global tier (one warp a pair: no tile or CTA seams) on the same inputs,
    at _seams_check's bounds: K2 and K3 in the same float64 arithmetic, K3
    local (global bands' tables differ by the order of the float32 sums of
    their weights over the deletion chains, held by the exact tests).
    Then the global tier at the same tiling: the same code on the same
    sums, each thread's run in global memory, so the same bits as the
    shared tier, both kernels (the tier seam)."""
    _need_card()
    assert estep.estep_route_ok(W, ("smem", tiling), "bwd_counts")
    lanes = _two_level_seam_lanes(W, tiling)
    assert len(lanes) >= 2 * tiling[0]
    pb = _seam_pairs(np.random.default_rng(19), lanes, W=W)
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(_tables("packed"), "cuda")
    _seams_check(inp, v2, local, {k: (("smem", tiling), _one_tile(W))
                                  for k in ("fwd_store", "bwd_counts")},
                 k3=local)
    _tiers_check(inp, v2, local, tiling)


def _tiers_check(inp, v2, local, tiling, k3=True):
    """K2 (and with k3 K3, on K2's shared-tier store) on the smem routes'
    shared and global tiers at the same tiling on the same inputs: the
    same bits, each launch counted on its tier."""
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2)
    got, store, wrow = {}, None, None
    for kind in ("smem", "global"):
        n = [getattr(estep.fwd_store, f"{kind}_launches"),
             getattr(estep.bwd_counts, f"{kind}_launches")]
        out = estep.fwd_store(**inp, tables=v2, local=local,
                              route=(kind, tiling))
        if store is None:
            fwd = out[0]
            store = out[1:]
            wrow = torch.stack([torch.full_like(fwd, 0.5),
                                torch.where(fwd > fill_v2.NEG_INF / 2, fwd,
                                            0.0)]).contiguous()
        if k3:
            out += estep.bwd_counts(*base, wrow, *store, local=local,
                                    route=(kind, tiling))
        torch.cuda.synchronize()
        assert [getattr(estep.fwd_store, f"{kind}_launches"),
                getattr(estep.bwd_counts, f"{kind}_launches")] == [
            n[0] + 1, n[1] + int(k3)]
        got[kind] = out
    # rows and offsets past a pair's read length are left unwritten
    ylen = inp["meta"][:, 1].tolist()
    for i, (a, b) in enumerate(zip(got["smem"], got["global"])):
        if i in (1, 2):
            for p, n in enumerate(ylen):
                assert torch.equal(a[..., p, :n, :] if i == 1 else a[p, :n],
                                   b[..., p, :n, :] if i == 1 else b[p, :n])
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("W, tiling", [
    (estep.ESTEP_SMEM_MAX_LANES["bwd_counts"], (16, 16, 10)),
    (estep.ESTEP_SMEM_MAX_LANES["fwd_store"], (16, 16, 15))], ids=str)
def test_estep_smem_tiers_match(W, tiling):
    """At each kernel's widest shared-tier band, on the tiling of its table
    row there (K3's shared tier ends at 81920 lanes, K2's at 122880), both
    tiers on random local strips over a ref as wide as the band give the
    same bits (_tiers_check), K2 past K3's widest band on the tiling K2's
    run fits; and both against the plain versions."""
    _need_card()
    for k in ("fwd_store", "bwd_counts"):
        if estep.ESTEP_SMEM_MAX_LANES[k] == W:
            assert estep.estep_route(W, k) == ("smem", tiling)
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 3),
                                 _tables("packed"), W, B=2,
                                 Lx=W + 64, Ly=120)
    case = _plain_case(inp, v2, True)
    k3_smem = estep.estep_route_ok(W, ("smem", tiling), "bwd_counts")
    r3 = ("smem", tiling) if k3_smem else _global(W)
    _estep_routes_check(*case, [(("smem", tiling), r3),
                                (("global", tiling), ("global", tiling))])
    _tiers_check(inp, v2, True, tiling, k3=k3_smem)


def _estep_smem_table_tilings():
    """(kernel, route, W): each ESTEP_SMEM_TABLE row's tiling at its
    widest band, and the global tier's at the band one lane past each
    kernel's table and at 131072 and 262144 lanes."""
    out = []
    for k, table in estep.ESTEP_SMEM_TABLE.items():
        for W in [row[0] for row in table] + [table[-1][0] + 1, 131072,
                                              262144]:
            out.append((k, estep.estep_route(W, k), W))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, route, W", _estep_smem_table_tilings(),
                         ids=str)
def test_estep_smem_table_tilings(kernel, route, W):
    """K2's or K3's smem route at each tiling of its ESTEP_SMEM_TABLE rows
    on the row's widest band (random local strips over a ref as wide as
    the band), and its global tier past the table, the other kernel on its
    own route, against the plain versions; K2's stored rows against the
    plain version's; each kernel rerun bit for bit."""
    _need_card()
    assert estep.estep_route(W, kernel) == route
    assert route[0] == ("smem" if W <= estep.ESTEP_SMEM_MAX_LANES[kernel]
                        else "global")
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 5),
                                 _tables("packed"), W, B=2, Lx=W + 64,
                                 Ly=120)
    case = _plain_case(inp, v2, True)
    pair = ((route, estep.estep_route(W, "bwd_counts"))
            if kernel == "fwd_store"
            else (estep.estep_route(W, "fwd_store"), route))
    _estep_routes_check(*case, [pair])
    _stored_rows_check(inp, v2, True, *estep.fwd_store(
        **inp, tables=v2, local=True, route=pair[0])[1:])


# forced smem tilings past 65536 lanes: the shared tier where a CTA's run
# fits (8 warps of more lanes a thread), the global tier at 8 and 16
# warps, at 65537, 98304, 131072 and 262144 lanes
ESTEP_SMEM_FORCED = [
    (65537, ("smem", (9, 16, 15))), (65537, ("global", (16, 8, 17))),
    (98304, ("smem", (16, 16, 12))), (98304, ("global", (16, 8, 24))),
    (98304, ("global", (8, 16, 24))), (131072, ("global", (16, 8, 32))),
    (131072, ("global", (8, 16, 32))), (262144, ("global", (16, 8, 64))),
    (262144, ("global", (16, 4, 128)))]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["local", "global-gap1"])
@pytest.mark.parametrize("W, route", ESTEP_SMEM_FORCED, ids=str)
def test_estep_smem_forced_tilings(W, route, variant):
    """Both kernels on a forced smem tiling past 65536 lanes (K3 on the
    global tier at the same tiling where its run does not fit a CTA),
    against the plain versions: local random strips over a ref as wide as
    the band, or a gap-order-1 global long-deletion band (reads of 1024
    rows over refs of W / 2 + 64 bases) normalised by the float64 forward
    fill (_plain_case's exact)."""
    _need_card()
    local, tables = ESTEP_VARIANTS[variant]
    kw = (dict(Lx=W + 64, Ly=120) if local
          else dict(Lx=W // 2 + 64, Ly=1024))
    inp, v2 = random_fill_inputs(np.random.default_rng(W + 9),
                                 _tables(tables), W, B=2, local=local, **kw)
    r3 = (route if estep.estep_route_ok(W, route, "bwd_counts")
          else ("global", route[1]))
    assert estep.estep_route_ok(W, route, "fwd_store")
    _estep_routes_check(*_plain_case(inp, v2, local, exact=not local),
                        [(route, r3)])


@pytest.mark.cuda
def test_estep_cluster_refused_launch_raises():
    """K2's and K3's cluster routes at 16 CTAs with one fold are refused
    by the card, at 32 CTAs with two by the entries, and their smem routes
    at 17 CTAs or 17 warps a CTA by the entries, at 64 lanes a thread
    (more shared memory than a CTA may hold) by the card, and on the
    global tier with a slab one byte short of every CTA's run or a tiling
    that does not cover the band by the entries: they return an error,
    which the wrappers' launch check raises.  The wrappers themselves take
    no cluster of more than MAX_CLUSTER_CTAS CTAs with one fold or
    MAX_CLUSTER_CTAS2 with two (none of K2's), nor an smem tiling past 16
    CTAs, 16 warps or 16 lanes a thread (or whose run does not fit a CTA),
    nor a tiling that cannot cover the band, has more warps a CTA than the
    kernel or is not (CTAs, warps, lanes): they raise before any launch."""
    _need_card()
    from quaff_tpu_torch import kernels

    inp, v2, local, fwd_p, wrow, part_p, sc_p, fwd32 = _estep_plain(
        "local", 2048, 3)
    B, W = inp["doff"].shape
    Ly, Lx, S = inp["keys"].shape[1], inp["x_tok"].shape[1], \
        inp["seg_start"].shape[1]
    tabs = (v2.match.data_ptr(), v2.match_noq.data_ptr(),
            v2.insert.data_ptr(), v2.insert_noq.data_ptr(),
            v2.match.shape[1], v2.match.shape[2], v2.ik.data_ptr(), v2.n_ik,
            v2.trans.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(B + B * S, device="cuda")
    rows = torch.empty((3, B, Ly, W), device="cuda")
    offs = torch.empty((B, Ly), dtype=torch.float64, device="cuda")
    part = torch.empty((B, estep.table_size(v2)), device="cuda")
    d_sc = torch.empty((5, B), device="cuda")
    before = [estep.fwd_store.launches, estep.bwd_counts.launches]
    lib = kernels.library()
    # one fold: 16 CTAs, past the portable 8 (refused by the card); two
    # levels: 32 CTAs, past the 16 its launch opts in to (refused by the
    # entry)
    for mode, nct in ((estep.ONE_FOLD, 16), (estep.TWO_FOLD, 32)):
        err = lib.quaff_fwd_store_cluster(
            inp["x_tok"].data_ptr(), Lx, inp["keys"].data_ptr(), Ly,
            inp["meta"].data_ptr(), inp["doff"].data_ptr(), W,
            inp["seg_start"].data_ptr(), inp["seg_width"].data_ptr(), S,
            *tabs, B, int(local), 4, nct, 1, mode, out.data_ptr(),
            rows.data_ptr(), offs.data_ptr(), stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="cluster route"):
            kernels.check_launch(err, "fwd_store", ("cluster", (nct, 1, 4)),
                                 "")
        err = lib.quaff_bwd_counts_cluster(
            inp["x_tok"].data_ptr(), Lx, inp["keys"].data_ptr(), Ly,
            inp["meta"].data_ptr(), inp["doff"].data_ptr(), W, *tabs,
            wrow.data_ptr(), rows.data_ptr(), offs.data_ptr(), B, int(local),
            4, nct, 1, mode, part.data_ptr(), d_sc.data_ptr(), stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="cluster route"):
            kernels.check_launch(err, "bwd_counts", ("cluster", (nct, 1, 4)),
                                 "")
    # the smem routes: 17 CTAs or 17 warps a CTA (the entries), 64 lanes a
    # thread of 16 warps (the card: 917504 bytes of shared memory a CTA);
    # the global tier (kind "global": a slab) one byte short of every
    # CTA's run, and 1 x 1 x 4 lanes, which does not cover the band
    def short_slab(k, tiling):
        buf = torch.empty(estep.slab_bytes(k, B, tiling), dtype=torch.uint8,
                          device="cuda")
        return buf, (buf.data_ptr(), buf.numel() - 1)

    for kind, (nct, warps, lpt) in (("smem", (17, 1, 4)),
                                    ("smem", (1, 17, 4)),
                                    ("smem", (1, 16, 64)),
                                    ("global", (4, 16, 1)),
                                    ("global", (1, 1, 4))):
        for k in ("fwd_store", "bwd_counts"):
            buf, slab = (None, (0, 0)) if kind == "smem" else short_slab(
                k, (nct, warps, lpt))
            if (nct, warps, lpt) == (1, 1, 4):
                slab = (slab[0], slab[1] + 1)  # whole, but W > 128 lanes
            if k == "fwd_store":
                err = lib.quaff_fwd_store_smem(
                    inp["x_tok"].data_ptr(), Lx, inp["keys"].data_ptr(), Ly,
                    inp["meta"].data_ptr(), inp["doff"].data_ptr(), W,
                    inp["seg_start"].data_ptr(), inp["seg_width"].data_ptr(),
                    S, *tabs, B, int(local), lpt, nct, warps, *slab,
                    out.data_ptr(), rows.data_ptr(), offs.data_ptr(), stream)
            else:
                err = lib.quaff_bwd_counts_smem(
                    inp["x_tok"].data_ptr(), Lx, inp["keys"].data_ptr(), Ly,
                    inp["meta"].data_ptr(), inp["doff"].data_ptr(), W, *tabs,
                    wrow.data_ptr(), rows.data_ptr(), offs.data_ptr(), B,
                    int(local), lpt, nct, warps, *slab, part.data_ptr(),
                    d_sc.data_ptr(), stream)
            assert err != 0
            with pytest.raises(RuntimeError, match=f"{kind} route"):
                kernels.check_launch(err, k, (kind, (nct, warps, lpt)), "")
            del buf
    base = (inp["x_tok"], inp["keys"], inp["meta"], inp["doff"], v2, wrow)
    # too many CTAs (one fold: 8; two levels: 16), too few tiles, too many
    # warps a CTA, two levels (K2), a fourth element
    for bad in ((16, 1, 4), (9, 3, 16), (17, 2, 4), (1, 2, 4), (1, 16, 16),
                (8, 9, 16), (9, 4, 4), (8, 5, 4, 2)):
        with pytest.raises(ValueError, match="no route"):
            estep.fwd_store(**inp, tables=v2, route=("cluster", bad))
    for kind, bad in (("smem", (17, 1, 4)), ("smem", (1, 17, 4)),
                      ("smem", (1, 1, 17)), ("smem", (1, 1, 4)),
                      ("smem", (1, 4, 4, 2)), ("global", (17, 1, 4)),
                      ("global", (1, 17, 4)), ("global", (1, 1, 4)),
                      ("global", (1, 1, 0)), ("global", (1, 4, 4, 2))):
        with pytest.raises(ValueError, match="no route"):
            estep.fwd_store(**inp, tables=v2, route=(kind, bad))
        with pytest.raises(ValueError, match="no route"):
            estep.bwd_counts(*base, rows, offs, route=(kind, bad))
    for bad in ((16, 1, 4), (9, 3, 16), (17, 2, 4), (1, 2, 4), (2, 16, 4),
                (8, 9, 8), (8, 5, 4, 2)):
        with pytest.raises(ValueError, match="no route"):
            estep.bwd_counts(*base, rows, offs, route=("cluster", bad))
    assert [estep.fwd_store.launches, estep.bwd_counts.launches] == before
    # the card runs on: the tables' routes on the same inputs
    _estep_routes_check(inp, v2, local, fwd_p, wrow, part_p, sc_p, fwd32,
                        [(estep.estep_route(W, "fwd_store"),
                          estep.estep_route(W, "bwd_counts"))])


def _long_read_band(W, seed):
    """Two pairs of random reads of 4300-8600 rows in full bands of up to W
    lanes (one strip over every diagonal of the read and a ref of up to
    W - ylen + 1 bases), the longer of 8534 rows: the long reads'
    wide bands of align -kmatchoff, run in local mode."""
    inp, v2 = random_fill_inputs(np.random.default_rng(seed),
                                 _tables("packed"), W, B=2, Lx=9000,
                                 Ly=8600, local=False)
    assert int(inp["meta"][:, 1].max()) > 8000
    return inp, v2


def _long_read_pairs(rng, W, lanes, xlen=9000, ylens=(8600, 8200)):
    """Pairs of a random ref and a long read copied from it as
    chip_smoke.py's workloads copy them (each base substituted with
    probability 7.2%, followed by an inserted base 2.4%, deleted 2.4%;
    qualities drawn from the c8f30 read's, which the default model fits),
    each in a band of W contiguous diagonals (halo lanes included) whose
    lane lanes[i] holds the read's first diagonal: a long read's wide band
    in a training chunk, every lane live, the path near a chosen lane (a
    CTA boundary of the cluster tiling, say)."""
    from quaff_tpu_torch.io.fastseq import read_fast_seqs

    quals = read_fast_seqs(str(DATA / "c8f30.fastq.gz"))[0].qual_scores()
    pairs = []
    for i, (lane, ylen) in enumerate(zip(lanes, ylens)):
        xs = "".join("ACGT"[t] for t in rng.integers(0, 4, xlen))
        d = 100 + 50 * i
        ys, k = [], d
        while len(ys) < ylen and k < xlen:
            r = rng.random()
            if r < 0.072:  # substituted
                ys.append("ACGT"["ACGT".index(xs[k]) ^ int(rng.integers(1, 4))])
            elif r < 0.096:  # followed by an inserted base
                ys += [xs[k], "ACGT"[int(rng.integers(0, 4))]]
            elif r >= 0.12:  # kept (0.096-0.12: deleted)
                ys.append(xs[k])
            k += 1
        q = "".join(chr(33 + int(v)) for v in rng.choice(quals, len(ys)))
        lo = d - lane + 1  # the band's first member diagonal (lane 1)
        assert 1 - len(ys) <= lo and lo + W - 3 <= xlen - 1
        env = Envelope(x_len=xlen, y_len=len(ys),
                       diagonals=np.arange(lo, lo + W - 2, dtype=np.int64))
        pairs.append((FastSeq(name=f"x{i}", seq=xs),
                      FastSeq(name=f"y{i}", seq="".join(ys), qual=q), env))
    pb = PairBatch.build(pairs, _tables("packed"))
    assert pb.member.shape[1] == W
    return pb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
def test_fill_cluster_widest_band_long_reads(mode):
    """K1's cluster route at the table's widest row (16384 lanes: 8 x 4 x
    16, 16 lanes a thread) on reads of about 8600 rows, the length at
    which phase 4's 4038-lane chunk showed 16-lane tilings 0.445 nats off
    the plain version, against the plain version at K1's own rtol 1e-5 /
    atol 1e-3."""
    _need_card()
    W = fill_v2.FILL_CLUSTER_MAX_LANES
    assert fill_v2.fill_route(W) == ("cluster", (8, 4, 16))
    inp, v2 = _long_read_band(W, 102)
    _fill_checked(inp, v2, mode, True)


@pytest.mark.cuda
def test_estep_cluster_widest_band_long_reads():
    """K2's and K3's cluster routes at the train path's widest band
    (ESTEP_WIDE_LANES, 4096 lanes, 8 x 4 x 4) on reads of 8600 and 8200
    rows copied from their refs, in bands of 4096 live lanes with the
    paths starting on a CTA boundary (lane 2048) and inside a tile (lane
    1151): phase 5b's wide read at the table's widest band of the train
    path.  Against the plain versions at their tolerances (forward scores
    rtol 1e-5 / atol 1e-3, counts rtol 3e-3 / atol 5e-3, the back-start
    posterior 5e-3); K2's stored rows against the plain version's."""
    _need_card()
    W = estep.ESTEP_WIDE_LANES
    pb = _long_read_pairs(np.random.default_rng(102), W, [2048, 1151])
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(_tables("packed"), "cuda")
    assert int(inp["meta"][:, 1].max()) > 8000
    case = _plain_case(inp, v2, True)
    assert bool((case[3] > fill_v2.NEG_INF / 2).all())
    local = True
    routes = tuple(estep.estep_route(W, k) for k in ("fwd_store",
                                                      "bwd_counts"))
    assert routes == (("cluster", (8, 4, 4)), ("cluster", (8, 4, 4)))
    _estep_routes_check(*case, [routes])
    _stored_rows_check(inp, v2, local, *estep.fwd_store(
        **inp, tables=v2, local=local)[1:])


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


# K1's smem route (csrc/band_fill_smem.cuh): the bands past the register
# cluster route's widest, up to FILL_SMEM_MAX_LANES
FILL_SMEM_WIDTHS = (fill_v2.FILL_CLUSTER_MAX_LANES + 1, 22882, 49500,
                    fill_v2.FILL_SMEM_MAX_LANES)


def _fill_wide_inputs(variant, W, seed, B=4, Ly=120):
    """_variant_inputs at W lanes: local bands of 1-3 strips at random
    diagonals; global ones over refs of up to nearly W bases, each lane
    live in a few rows and most tiles dead in most rows."""
    mode, local, qual, gap = FILL_VARIANTS[variant]
    tt = _tables("gaporder1" if gap else "packed")
    inp, v2 = random_fill_inputs(np.random.default_rng(seed), tt, W, B=B,
                                 Lx=W - Ly if not local else 300, Ly=Ly,
                                 local=local, qual=qual)
    return inp, v2, mode, local


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["viterbi", "forward", "global",
                                     "forward-global"])
@pytest.mark.parametrize("W", FILL_SMEM_WIDTHS)
def test_fill_smem_routes_match_plain(W, variant):
    """K1 through the wrapper on random bands of 16385, 22882 (phase 4b's
    align -kmatchoff chunk), 49500 (a lambda-length ref) and
    FILL_SMEM_MAX_LANES lanes: the smem route, its pair scores and strip
    maxima against band_fill_reference; a rerun is bit-identical."""
    _need_card()
    assert fill_v2.fill_route(W)[0] == "smem"
    inp, v2, mode, local = _fill_wide_inputs(variant, W, 61 + W)
    got = _fill_checked(inp, v2, mode, local)
    assert torch.equal(
        fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local), got)


def _fill_smem_table_tilings():
    """Each FILL_SMEM_TABLE row's tilings at its narrowest and widest band
    (fewest and most CTAs at its lanes a thread), with those widths."""
    out, lo = [], fill_v2.FILL_CLUSTER_MAX_LANES + 1
    for widest, _, _ in fill_v2.FILL_SMEM_TABLE:
        for W in (lo, widest):
            kind, tiling = fill_v2.fill_route(W)
            assert kind == "smem"
            if (tiling, W) not in out:
                out.append((tiling, W))
        lo = widest + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["viterbi", "forward", "global"])
@pytest.mark.parametrize("tiling, W", _fill_smem_table_tilings(), ids=str)
def test_fill_smem_table_tilings(tiling, W, variant):
    """K1's smem route at each FILL_SMEM_TABLE row's tilings, on the
    narrowest and widest band of the row (local: random strips, and strips
    seamed on tile and CTA boundaries; global: one strip over every
    diagonal), against the plain version; a rerun is bit-identical."""
    _need_card()
    mode, local, qual, gap = FILL_VARIANTS[variant]
    assert fill_v2.fill_route(W) == ("smem", tiling)
    tt = _tables("packed")
    for seams in ((None, _tile_seams(W, tiling)) if local else (None,)):
        inp, v2 = random_fill_inputs(np.random.default_rng(W), tt, W, B=3,
                                     Lx=300 if local else W - 80, Ly=80,
                                     local=local, qual=qual, seams=seams)
        got = _fill_checked(inp, v2, mode, local)
        assert torch.equal(
            fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local), got)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(FILL_VARIANTS))
@pytest.mark.parametrize("tiling", [(1, 1, 1), (1, 3, 5), (2, 2, 2),
                                    (5, 3, 3), (9, 4, 1), (16, 2, 3),
                                    (3, 16, 2)], ids=str)
def test_fill_smem_forced_tilings(tiling, variant):
    """K1's smem route forced at 1 to 16 CTAs of 1 to 16 warps and 1 to 5
    lanes a thread, on bands it fills exactly: local variants with strips
    seamed on tile and CTA boundaries (the last ending on a member lane at
    the last CTA's last lane), global ones over reads a quarter of the band
    long, whose tiles are dead in most rows; the global tier at the same
    tiling on the same inputs, bit for bit the shared tier."""
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
                                     Ly=max(W // 4, 8), local=False,
                                     qual=qual)
    got = _fill_checked(inp, v2, mode, local, ("smem", tiling))
    assert torch.equal(
        _fill_checked(inp, v2, mode, local, ("global", tiling)), got)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("W", [22882, fill_v2.FILL_SMEM_MAX_LANES])
def test_fill_smem_long_reads(W, mode):
    """K1's smem route at phase 4b's width (22882 lanes: 15 x 8 x 6) and
    at the table's widest band on reads of about 8600 rows
    (_long_read_band), the length at which phase 4's chunk showed the
    register cluster route's 16-lane tilings 0.445 nats off the plain
    version, against the plain version at K1's own rtol 1e-5 / atol
    1e-3."""
    _need_card()
    assert fill_v2.fill_route(W)[0] == "smem"
    inp, v2 = _long_read_band(W, 102)
    _fill_checked(inp, v2, mode, True)


def _indel_seam_pairs(rng, bounds, W, ylen=80, k=4):
    """For each tile or CTA boundary b of `bounds` (the band's first lane
    of a tile), two pairs of a random ref and a read copied from it
    (qualities, no substitution), each ylen bases, in full envelopes of W
    lanes whose alignment crosses the boundary in one row: a deletion of k bases that
    takes the path from lane b - k/2 to b + k/2 (its delete chain across
    the seam), and an insertion of k bases that takes it back (the insert
    cells of the next tile's first lane)."""
    xlen = W - ylen - 1
    pairs = []
    for b in bounds:
        for dele in (True, False):
            lane0 = b - k // 2 if dele else b + k // 2
            d = lane0 - ylen  # the read's first diagonal
            assert 0 <= d and d + ylen + k < xlen
            xs = "".join("ACGT"[t] for t in rng.integers(0, 4, xlen))
            h = ylen // 2
            if dele:
                ys = xs[d:d + h] + xs[d + h + k:d + ylen + k]
            else:
                ys = (xs[d:d + h] + "".join(
                    "ACGT"[t] for t in rng.integers(0, 4, k))
                    + xs[d + h:d + ylen - k])
            q = "".join(chr(33 + int(v)) for v in rng.integers(20, 40,
                                                               len(ys)))
            pairs.append((FastSeq(name=f"x{b}", seq=xs),
                          FastSeq(name=f"y{b}", seq=ys, qual=q),
                          full_envelope(xlen, len(ys))))
    pb = PairBatch.build(pairs, _tables("packed"))
    assert pb.member.shape[1] == W
    return pb


@pytest.mark.cuda
@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("W, tiling", [(22882, (15, 8, 6)),
                                       (49500, (14, 16, 7)),
                                       (4608, (4, 4, 9)),
                                       (1536, (3, 2, 8))], ids=str)
def test_fill_smem_seams_match_the_block_route(W, tiling, local, mode):
    """K1's smem route on paths that cross a tile boundary and each CTA
    boundary (_indel_seam_pairs: a deletion and an insertion across each),
    against the plain version and, local, against one warp a pair on the
    global tier (_one_tile: no tile or CTA seams) on the same inputs,
    at K1's rtol 1e-5 / atol 1e-3: a lost delete chain or insert cell at a
    seam moves the local path's score by nats.  The global paths (the
    whole ref: up to ~49000 deletions, every seam crossed) are held against
    the plain version alone: there two routes each came within the
    tolerance of the plain version but 0.32 nats (1.2e-5 of -27240) apart
    at 49500 lanes, the order of float32 sums over the deletion chains
    (measured on the card)."""
    _need_card()
    assert fill_v2._fill_route_ok(W, ("smem", tiling))
    nct, warps, lpt = tiling
    tile, cta = 32 * lpt, 32 * lpt * warps
    bounds = [tile] + [c * cta for c in range(1, nct) if c * cta < W - 400]
    pb = _indel_seam_pairs(np.random.default_rng(23), bounds, W)
    inp = fill_v2.kernel_inputs(to_device(pb, "cuda"))
    v2 = fill_v2.V2Tables.from_tables(_tables("packed"), "cuda")
    got = _fill_checked(inp, v2, mode, local, ("smem", tiling))
    if local:
        one = _fill_checked(inp, v2, mode, local, _one_tile(W))
        _assert_scores_close(got, one, len(bounds))


@pytest.mark.cuda
def test_fill_smem_refused_launch_raises():
    """K1's smem route at 17 CTAs or 17 warps a CTA is refused by the
    entry, at 64 lanes a thread of 16 warps (512 KB, past a CTA's 227 KB)
    by the card, and its global tier with a slab a byte short of every
    CTA's run (or of a negative size): the entry returns an error, which
    the wrapper's launch check raises.  The wrapper itself takes no such
    tiling, nor one that cannot cover the band or whose shared-tier CTA
    does not fit the card's shared memory (_fill_route_ok): it raises
    before any launch."""
    _need_card()
    from quaff_tpu_torch import kernels

    W = fill_v2.FILL_CLUSTER_MAX_LANES + 1
    inp, v2, mode, local = _fill_wide_inputs("viterbi", W, 5, B=2, Ly=40)
    B = inp["doff"].shape[0]
    before = fill_v2.band_fill.launches
    out = torch.empty(B + B * inp["seg_start"].shape[1], device="cuda")
    args = fill_v2.launch_args(**inp, tables=v2, mode=mode, local=local)
    stream = torch.cuda.current_stream().cuda_stream
    for nct, warps, lpt in ((17, 16, 2), (2, 17, 16), (1, 16, 64)):
        err = kernels.library().quaff_band_fill_smem(
            *args, lpt, nct, warps, 0, 0, out.data_ptr(), stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="smem route"):
            kernels.check_launch(err, "band_fill", ("smem", (nct, warps, lpt)),
                                 "")
    tiling = fill_v2.global_tiling(W, fill_v2.FILL_GLOBAL_WARPS)
    need = fill_v2.fill_slab_bytes(B, tiling)
    slab = torch.empty(need, dtype=torch.uint8, device="cuda")
    nct, warps, lpt = tiling
    for size in (need - 1, -1):
        err = kernels.library().quaff_band_fill_smem(
            *args, lpt, nct, warps, slab.data_ptr(), size, out.data_ptr(),
            stream)
        assert err != 0
        with pytest.raises(RuntimeError, match="global route"):
            kernels.check_launch(err, "band_fill", ("global", tiling), "")
    for bad in ((17, 16, 2), (2, 17, 16), (1, 16, 64), (2, 16, 28),
                (11, 16, 2), (1, 2, 4)):
        with pytest.raises(ValueError, match="no route"):
            fill_v2.band_fill(**inp, tables=v2, route=("smem", bad))
    for bad in ((17, 16, 2), (2, 17, 16), (1, 2, 4)):
        with pytest.raises(ValueError, match="no route"):
            fill_v2.band_fill(**inp, tables=v2, route=("global", bad))
    assert fill_v2.band_fill.launches == before
    # the card runs on: the table's route, and the global tier with a slab
    # of exactly its size, on the same inputs
    _fill_checked(inp, v2, mode, local)
    err = kernels.library().quaff_band_fill_smem(
        *args, lpt, nct, warps, slab.data_ptr(), need, out.data_ptr(), stream)
    torch.cuda.synchronize()
    assert err == 0
    _assert_scores_close(out, fill_v2.band_fill_reference(
        **inp, tables=v2, mode=mode, local=local), B)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
def test_fill_block_route_past_the_smem_route(mode):
    """One lane past FILL_SMEM_MAX_LANES (221184: 27 lanes a thread, the
    most a CTA's shared memory holds) K1 takes its smem route's global
    tier at 16 CTAs of 16 warps and 28 lanes a thread, each thread's run
    in a per-pair slab of global memory, against the plain version on
    local and global bands; a rerun is bit-identical."""
    _need_card()
    W = fill_v2.FILL_SMEM_MAX_LANES + 1
    assert fill_v2.fill_route(W) == ("global", (16, 16, 28))
    for variant in ((mode,) if mode == "forward" else (mode, "global")):
        inp, v2, m, local = _fill_wide_inputs(variant, W, 9, B=2, Ly=60)
        got = _fill_checked(inp, v2, m, local)
        assert torch.equal(
            fill_v2.band_fill(**inp, tables=v2, mode=m, local=local), got)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["viterbi", "forward", "global",
                                     "forward-global"])
@pytest.mark.parametrize("W, tiling", [
    (22882, (15, 8, 6)), (131073, (16, 16, 17)),
    (fill_v2.FILL_SMEM_MAX_LANES, (16, 16, 27))], ids=str)
def test_fill_smem_tiers_match(W, tiling, variant):
    """K1's smem route's two tiers at one tiling (the table's at phase
    4b's 22882 lanes, one lane past the former 131072, and at the shared
    tier's widest band) on the same inputs: the same row loop and fold on
    the same sums, each thread's run in shared or in global memory, so the
    same bits, each launch counted on its tier; both against the plain
    version."""
    _need_card()
    assert fill_v2.fill_route(W) == ("smem", tiling)
    inp, v2, mode, local = _fill_wide_inputs(variant, W, 71 + W, B=2, Ly=60)
    got = _fill_checked(inp, v2, mode, local, ("smem", tiling))
    assert torch.equal(
        _fill_checked(inp, v2, mode, local, ("global", tiling)), got)


# K1's smem route on bands of up to 131072 lanes (at most 16 lanes a
# thread at their table tilings), whose delete chain adds at the cells'
# magnitude: the sha256 of each case's output bytes (_fill_digests) as the
# smem kernel before its relative chain past 16 lanes a thread computed
# them on the card (NVIDIA H100 80GB HBM3).  To make them with another
# checkout's kernels, run _fill_digests with that checkout's package first
# on sys.path (from its root: PYTHONPATH=<this repo>/tests python -c
# "import test_torch_kernel_cuda as t; print(t._fill_digests())").
FILL_DIGEST_WIDTHS = (16385, 22882, 49500, 131072)
FILL_DIGESTS = {
    "16385-forward":
        "9a080f27c1953b1d62f44007cfe955776085c576526e2edb5ba8a59889232ab7",
    "16385-forward-global":
        "36e1433c2c4542c167fc58cb77e1cdac94929a8ad09f0023384d8397924e56db",
    "16385-global":
        "6cddcff280c5d0aa099ba9c27d253dd60a46dcdf60cb703d8f27b9923964eb36",
    "16385-viterbi":
        "3c62091cfd3606e8a8b6760a65bd7582527bb158e587a342b68375a3f1141b4e",
    "22882-forward":
        "187a389ac28f870e35f62b0d7a0aaa81e779bae88c348a5df221c9f2bdb094da",
    "22882-forward-global":
        "e9f217fed3a762721a60407e668a5edb596816a0c054686751e3795a071bd514",
    "22882-global":
        "23732c3bf44c459e6fae723b78441d7bd5da9f1f94ab0aa96dbbd61c2b1d150a",
    "22882-viterbi":
        "984595642a758d24c40c5f7cbfa9858673835da82b42c856aa1d24eab4b6630c",
    "49500-forward":
        "d8ed9386152eeeb6af3da34e6dd208e05aa140da60a5705b4a8ede9f715cac59",
    "49500-forward-global":
        "51e8c5268c8dbedbfaa2d5d9d47663f8ea18984f0e1943be43166b224a9617b0",
    "49500-global":
        "91b93bf7e7d51fa9535f1af41b2feb8fe21d89cdb98a1de7a5155e4c91305d92",
    "49500-viterbi":
        "eeb0cfc2233e164b4b391dc0db9cf4b495d8353fa0c335227c10cdbed5575ead",
    "131072-forward":
        "8fe57cce6726b6a1568723a4e3a95a3dbb5e9fe815c0dac72606d207c642c0a4",
    "131072-forward-global":
        "0b341244b7b244660be06976d7695ab0e2e6c60f0e674d4fda14a61cc3aecd1f",
    "131072-global":
        "fd6ae2216c4506c54d6d16764712428b687edd2316dbfe18e44b11abe0f87d02",
    "131072-viterbi":
        "72cfbbc51325f4a0ec50a8d046722f48e410ab7ba669c41e1169df106488fdc4",
}


def _fill_digests():
    """{"W-variant": sha256 of K1's output on its table route} on random
    bands (_fill_wide_inputs, B=2, 60 rows) of FILL_DIGEST_WIDTHS lanes,
    local and global, Viterbi and Forward."""
    import hashlib

    out = {}
    for W in FILL_DIGEST_WIDTHS:
        for variant in ("viterbi", "forward", "global", "forward-global"):
            inp, v2, mode, local = _fill_wide_inputs(variant, W, 97 + W, B=2,
                                                     Ly=60)
            got = fill_v2.band_fill(**inp, tables=v2, mode=mode, local=local)
            out[f"{W}-{variant}"] = hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest()
    return out


@pytest.mark.cuda
def test_fill_smem_keeps_its_bits():
    """Bands of up to 131072 lanes keep their bits: K1's smem route at its
    table tilings there (16 lanes a thread at most, where the delete chain
    adds at the cells' magnitude, r0 = 0) gives the output the kernel gave
    before its relative chain past 16 lanes a thread (FILL_DIGESTS), local
    and global, Viterbi and Forward."""
    _need_card()
    assert all(fill_v2.fill_route(W)[0] == "smem"
               and fill_v2.fill_route(W)[1][2] <= 16
               for W in FILL_DIGEST_WIDTHS)
    assert _fill_digests() == FILL_DIGESTS


def _long_deletion_band(W, seed, B=2, ylen=60):
    """K1's inputs for B global pairs of a random read of ylen rows and a
    random ref of W - ylen + 1 bases (the widest the band holds) in one
    strip over every diagonal: every global path takes about W deletions,
    the longest delete chains a band of W lanes has, each row's cells at
    magnitudes up to ~W / 2 nats."""
    inp, v2 = random_fill_inputs(np.random.default_rng(seed),
                                 _tables("packed"), W, B=B, Lx=W, Ly=ylen,
                                 local=False)
    xlen = W - ylen + 1
    meta = inp["meta"].clone()
    meta[:, 0], meta[:, 1] = xlen, ylen
    doff = torch.arange(-(ylen - 1), xlen, dtype=torch.int32,
                        device="cuda").repeat(B, 1)
    seg_width = torch.zeros_like(inp["seg_width"])
    seg_width[:, 0] = W
    return dict(inp, meta=meta, doff=doff.contiguous(),
                seg_width=seg_width), v2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["viterbi", "forward"])
@pytest.mark.parametrize("W", [fill_v2.FILL_SMEM_MAX_LANES + 1, 262144])
def test_fill_global_tier_long_deletions(W, mode):
    """K1's global tier on global paths through the whole ref (about W
    deletions a pair: 28 and 32 lanes a thread, each thread composing its
    delete-chain steps at the cells' magnitude) against the plain version
    at K1's rtol 1e-5 / atol 1e-3; the gap and its share of the tolerance
    are printed (-rP)."""
    _need_card()
    assert fill_v2.fill_route(W)[0] == "global"
    inp, v2 = _long_deletion_band(W, 83 + W)
    got = _fill_checked(inp, v2, mode, False)
    ref = fill_v2.band_fill_reference(**inp, tables=v2, mode=mode,
                                      local=False)
    B = inp["doff"].shape[0]
    g, r = got[:B].double().cpu(), ref[:B].double().cpu()
    gap = (g - r).abs()
    share = gap / (1e-3 + 1e-5 * r.abs())
    print(f"K1 global tier {fill_v2.fill_route(W)[1]} W={W} {mode}: scores "
          f"{r.tolist()}, gap to the plain version {gap.tolist()} nats, "
          f"{float(share.max()):.3f} of K1's tolerance")


# the probes' chain at every layout: P1's [64, 256], the widths at each of
# K1's route edges (warp 1-512, cluster 513-16384, smem's shared tier
# 16385-221184, its global tier past it) and the five route shapes of
# roofline_probe.ROUTE_SHAPES, each at its own batch
SOL_SHAPES = [(64, 256), (3, 1), (3, 32), (3, 33), (3, 512), (3, 513),
              (3, 16384), (3, 16385), (3, 221184), (3, 221185), (2, 135),
              (71, 4038), (8, 22882), (2, 132396), (2, 264401)]


@pytest.mark.cuda
@pytest.mark.parametrize("B, W", SOL_SHAPES)
@pytest.mark.parametrize("op", ["add_max", "roll_add", "lse_guarded",
                                "raw_lse", "raw_lse_log"])
def test_sol_chain_matches_plain(op, B, W):
    """The probes' chain kernel (csrc/sol_probe.cu) at K1's layout for W
    lanes against chain_reference at GRID 2 x 64 steps: add_max and
    roll_add bitwise (exact operations in the same order; roll_add's lane 0
    takes lane W-1 across the row's last tile), the log-add-exp chains
    within rtol 1e-6 / atol 1e-5 (expf and log1pf of the card and
    PyTorch's kernels may differ by an ulp a step; the chain grows only
    like log(steps))."""
    _need_card()
    from quaff_tpu_torch.prof import chains, roofline_probe, sol_transcendental

    make = (roofline_probe.p1_inputs if op in ("add_max", "roll_add")
            else sol_transcendental.p2_inputs)
    a, b = make(B, W, "cuda")
    kind = chains.chain_route(W)[0]
    before = chains.chain.launches[op]
    before_layout = chains.chain.layout_launches[(op, kind)]
    got = chains.chain(op, a, b, 2, 64)
    torch.cuda.synchronize()
    assert chains.chain.launches[op] == before + 1
    assert chains.chain.layout_launches[(op, kind)] == before_layout + 1
    ref = chains.chain_reference(op, a, b, 2, 64)
    if op in ("add_max", "roll_add"):
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("lo, hi", [(1, 512), (513, 1100), (2040, 2060),
                                    (16370, 16400)])
def test_sol_roll_add_every_width(lo, hi):
    """roll_add bitwise equal to the plain version at every width of a
    range: each warp-layout width (its lane W-1 at every index of a
    thread's run, one instantiation each) and cluster and smem widths
    across a tiling's change, 16 steps from a, B=2."""
    _need_card()
    from quaff_tpu_torch.prof import chains, roofline_probe

    for W in range(lo, hi + 1):
        a, b = roofline_probe.p1_inputs(2, W, "cuda")
        got = chains.chain("roll_add", a, b, 1, 16)
        ref = chains.chain_reference("roll_add", a, b, 1, 16)
        assert torch.equal(got, ref), (W, chains.chain_route(W))


@pytest.mark.cuda
def test_nccl_rank_order_sum_is_the_one_rank_total():
    """In a one-rank NCCL group, where all_gather runs on the card: the
    rank-order float64 sum of the gathered count totals
    (parallel/distributed.sum_in_rank_order, which MeshCountsProvider
    takes) equals the one rank's totals bit for bit, and gather_floats
    returns each vector as sent, of any length."""
    _need_card()
    from quaff_tpu_torch.parallel import distributed

    rng = np.random.default_rng(5)
    totals = rng.standard_normal(1888) * 10.0 ** rng.integers(-30, 30, 1888)
    distributed.init_distributed(num_processes=1, backend="nccl")
    try:
        assert torch.distributed.get_backend() == "nccl"
        calls = distributed.gather_floats.calls
        summed = distributed.sum_in_rank_order(
            distributed.gather_floats(totals))
        (short,) = distributed.gather_floats(totals[:7])
        assert distributed.gather_floats.calls == calls + 2
    finally:
        distributed.shutdown_distributed()
    assert summed.dtype == np.float64
    assert np.array_equal(summed, totals)
    assert np.array_equal(short, totals[:7])
