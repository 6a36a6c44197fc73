"""The overlap model in the PyTorch port (quaff_tpu_torch/dp/overlap.py and
K4's plain version in dp/ov_fill.py) against the JAX package, on identical
inputs made from a numpy seed.

  OverlapScoreTables      bitwise equal, both strands, gap order 0 and 1
                          (each side reads the same params JSON)
  K4's plain version      against the Pallas kernel in interpret mode on the
                          same batches (bounding band, lane-packed and
                          row-trimmed with strip maxima, a sequence bank
                          whose rows pairs share):
                          rtol 1e-6 / atol 1e-4, the JAX package's
                          kernel-vs-kernel tolerance (tests/test_pallas_overlap.py);
                          against JAX's float64 overlap_fill: rtol 1e-5 /
                          atol 0.05 (exact vs the reference's truncated
                          log-sum-exp, ~1e-5 nats a column)

The CUDA kernel itself runs only on the card: tests/test_torch_kernel_cuda.py
and chip_smoke.py hold it against this plain version there.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quaff_tpu.dp.engine import _narrow_int
from quaff_tpu.dp.overlap import OverlapScoreTables as JaxTables
from quaff_tpu.dp.overlap import overlap_device_tables, overlap_fill
from quaff_tpu.dp.pallas_overlap import overlap_scores_kernel
from quaff_tpu.dp.pallas_overlap import (
    packed_overlap_descriptors as jax_descriptors,
)
from quaff_tpu.model.params import QuaffParams as JaxParams
from quaff_tpu.overlap import OverlapBatch as JaxOverlapBatch
from quaff_tpu_torch import native
from quaff_tpu_torch.dp import ov_fill
from quaff_tpu_torch.dp.overlap import OverlapScoreTables, _ref_lse
from quaff_tpu_torch.model.params import QuaffParams
from quaff_tpu_torch.overlap import _y_strand_arrays
from test_pallas_overlap import _make_params, _read_pairs
from test_torch_engine import port_pairs
from test_torch_kernel_cuda import bounding_band_desc, overlap_bank_batch

KERNEL = dict(rtol=1e-6, atol=1e-4)
F64 = dict(rtol=1e-5, atol=0.05)
CASES = [(g, yc) for g in (0, 1) for yc in (False, True)]
IDS = [f"gap{g}-{'rev' if yc else 'fwd'}" for g, yc in CASES]


def _params_pair(gap_order):
    """(JAX params, port params), each read from the same JSON text."""
    out = io.StringIO()
    _make_params(gap_order).write_json(out)
    text = out.getvalue()
    return JaxParams.from_json(text), QuaffParams.from_json(text)


def _tables(gap_order, y_comp):
    jp, qp = _params_pair(gap_order)
    return (JaxTables.from_params(jp, y_comp),
            OverlapScoreTables.from_params(qp, y_comp))


def _scores(tables, batch):
    """K4's plain version on a CPU batch: float64 pair scores [B] and
    per-strip end maxima [B, S]."""
    out = ov_fill.overlap_scores(tables, batch).numpy().astype(np.float64)
    B, S = batch["seg_start"].shape
    return out[:B], out[B:].reshape(B, S)


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.any()
    np.testing.assert_allclose(got[fin], want[fin], **tol)


def _multistrip_pairs(rng, n=4):
    """Overlaps on diagonals far from 0: multi-strip envelopes with a dead
    leading-row region (tests/test_pallas_overlap.py's construction)."""
    from quaff_tpu.alphabet import DNA_ALPHABET
    from quaff_tpu.envelope import sparse_envelope
    from quaff_tpu.io.fastseq import FastSeq, KmerIndex

    base = "".join("acgt"[t] for t in rng.integers(0, 4, 1400))
    pairs = []
    for b in range(n):
        xl = int(rng.integers(500, 700))
        x0 = int(rng.integers(0, 200))
        yl = int(rng.integers(300, 400))
        y0 = int(rng.integers(600, 900))
        ys = list(base[y0 : y0 + yl])
        for i in range(len(ys)):
            if rng.random() < 0.08:
                ys[i] = DNA_ALPHABET[int(rng.integers(0, 4))]
        x = FastSeq(name=f"x{b}", seq=base[x0 : x0 + xl],
                    qual="".join(chr(33 + int(q)) for q in rng.integers(3, 40, xl)))
        y = FastSeq(name=f"y{b}", seq="".join(ys),
                    qual="".join(chr(33 + int(q)) for q in rng.integers(3, 40, yl)))
        env = sparse_envelope(x, KmerIndex(y, 6), band_size=64, kmer_threshold=14)
        pairs.append((x, y, env))
    assert any(len(e.strips()) > 1 for *_, e in pairs)
    return pairs


@pytest.mark.parametrize("gap_order,y_comp", CASES, ids=IDS)
def test_overlap_tables_match_reference(gap_order, y_comp):
    jt, mine = _tables(gap_order, y_comp)
    for name in ("pair_qq", "pair_xq", "pair_yq", "pair_nn", "insert_score",
                 "insert_score_noq", "m2m", "m2i", "m2d", "i2m_eff",
                 "i2i_eff", "i2d_eff", "d2m_eff", "d2i_eff", "d2d_eff",
                 "match_kmer_len", "indel_kmer_len", "y_complemented",
                 "log_ref_base", "log_gap_open", "log_gap_stay",
                 "y_symbol_map"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(jt, name),
                                      err_msg=name)


def test_ref_lse_chain_native_matches_numpy():
    """The C ordered truncated-lse chain equals the numpy per-step loop
    bit for bit (the golden overlap scores depend on the truncation)."""
    rng = np.random.default_rng(3)
    terms = rng.normal(-5, 8, size=(200, 7, 13))
    terms[rng.random(terms.shape) < 0.1] = -np.inf
    terms[0] = -np.inf
    acc_c = np.full((7, 13), -np.inf)
    native.ref_lse_chain_native(acc_c, terms)
    acc_py = np.full((7, 13), -np.inf)
    for t in range(terms.shape[0]):
        acc_py = _ref_lse(acc_py, terms[t])
    assert np.array_equal(acc_c, acc_py)


@pytest.mark.parametrize("gap_order,y_comp", CASES, ids=IDS)
def test_k4_plain_matches_interpret_and_f64(gap_order, y_comp):
    """The bounding-band batch: each pair one strip spanning its band."""
    jt, mine = _tables(gap_order, y_comp)
    pairs = _read_pairs(np.random.default_rng(13), 4, y_comp)
    bdev = JaxOverlapBatch(pairs, jt).device()
    want = np.asarray(overlap_scores_kernel(jt, bdev, interpret=True))
    f64 = np.asarray(overlap_fill(overlap_device_tables(jt), bdev,
                                  return_matrices=False,
                                  dtype=jnp.float64)["score"])
    ppairs = port_pairs(pairs)
    got, _ = _scores(mine, overlap_bank_batch(
        ppairs, mine, bounding_band_desc(ppairs), "cpu"))
    _close(got, want, KERNEL)
    _close(got, f64, F64)


def _packed(pairs):
    return jax_descriptors([e for *_, e in pairs],
                           [len(x.seq) for x, _, _ in pairs],
                           [len(y.seq) for _, y, _ in pairs])


def test_packed_descriptors_match_reference():
    pairs = _multistrip_pairs(np.random.default_rng(23))
    want = _packed(pairs)
    got = ov_fill.packed_overlap_descriptors(
        [e for *_, e in port_pairs(pairs)],
        [len(x.seq) for x, _, _ in pairs], [len(y.seq) for _, y, _ in pairs])
    for g, w in zip(got[:5], want[:5]):
        np.testing.assert_array_equal(g, w)
    assert int(got[5].max()) == want[5]


@pytest.mark.parametrize("gap_order,y_comp", CASES, ids=IDS)
def test_k4_plain_packed_trimmed_segments(gap_order, y_comp):
    """Lane-packed strips with live-row windows: pair scores and per-strip
    end maxima against the interpret-mode kernel's return_segments."""
    from quaff_tpu.dp.pallas_v2 import _round_up

    jt, mine = _tables(gap_order, y_comp)
    pairs = _multistrip_pairs(np.random.default_rng(23))
    member, seg_d_lo, seg_start, seg_width, j_off, rows = _packed(pairs)
    d = dict(JaxOverlapBatch(pairs, jt).device())
    d.update(member=jnp.asarray(member), seg_d_lo=jnp.asarray(seg_d_lo),
             seg_start=jnp.asarray(seg_start), seg_width=jnp.asarray(seg_width),
             j_off=jnp.asarray(j_off))
    want_s, want_seg = overlap_scores_kernel(
        jt, d, interpret=True, n_rows=_round_up(max(rows, 1), 256),
        return_segments=True)

    ppairs = port_pairs(pairs)
    mine_d = overlap_bank_batch(ppairs, mine, ov_fill.packed_overlap_descriptors(
        [e for *_, e in ppairs], [len(x.seq) for x, _, _ in pairs],
        [len(y.seq) for _, y, _ in pairs]), "cpu")
    got_s, got_seg = _scores(mine, mine_d)
    _close(got_s, want_s, KERNEL)
    _close(got_seg, want_seg, KERNEL)
    # the pair score is the best strip plus the insert sums
    ins = np.asarray(mine_d["x_insert_score"] + mine_d["y_insert_score"])
    np.testing.assert_allclose(got_s, got_seg.max(axis=1) + ins, **KERNEL)


@pytest.mark.parametrize("gap_order,y_comp", CASES, ids=IDS)
def test_k4_plain_bank_matches_interpret(gap_order, y_comp):
    """The sequence-bank form (each read's rows once, per-pair row indices)
    against the interpret-mode kernel's bank form on the same rows."""
    jt, mine = _tables(gap_order, y_comp)
    jp, qp = _params_pair(gap_order)
    pairs = _read_pairs(np.random.default_rng(41), 4, y_comp=y_comp)
    reads, rows = [], {}
    for x, y, _ in pairs:
        for s, comp in ((x, False), (y, y_comp)):
            if (s.name, comp) not in rows:
                rows[(s.name, comp)] = len(reads)
                reads.append((s, comp))
    L = 512
    n = len(reads)
    arr = {k: np.zeros((n, L), np.int32) for k in ("tok", "mk", "ik", "q")}
    hq, lens = np.zeros(n, bool), np.zeros(n, np.int32)
    for r, (s, comp) in enumerate(reads):
        tok, mk, ik, q = _y_strand_arrays(
            port_pairs([(s, s, pairs[0][2])])[0][0],
            OverlapScoreTables.from_params(qp, comp))
        ln = len(tok)
        arr["tok"][r, :ln], arr["mk"][r, :ln], arr["ik"][r, :ln] = tok, mk, ik
        if q is not None:
            arr["q"][r, :ln], hq[r] = q, True
        lens[r] = ln
    bpairs = JaxOverlapBatch(pairs, jt)
    common = {
        "x_len": [len(x.seq) for x, _, _ in pairs],
        "y_len": [len(y.seq) for _, y, _ in pairs],
        "member": bpairs.base.member,
        "x_insert_score": bpairs.x_insert_score,
        "y_insert_score": bpairs.y_insert_score,
    }
    x_row = [rows[(x.name, False)] for x, _, _ in pairs]
    y_row = [rows[(y.name, y_comp)] for _, y, _ in pairs]
    d = {
        "d_lo": jnp.asarray(bpairs.base.d_lo),
        "bank_tok": _narrow_int(arr["tok"], 4),
        "bank_mk": _narrow_int(arr["mk"], 4 ** max(jt.match_kmer_len, 1)),
        "bank_q": _narrow_int(arr["q"], 94),
        "bank_hq": jnp.asarray(hq),
        "x_row": jnp.asarray(x_row, jnp.int32),
        "y_row": jnp.asarray(y_row, jnp.int32),
        **{k: jnp.asarray(np.asarray(v)) for k, v in common.items()},
    }
    if gap_order:
        d["bank_ik"] = _narrow_int(arr["ik"], 4 ** gap_order)
    want = np.asarray(overlap_scores_kernel(jt, d, interpret=True, n_rows=L))

    # the port's bank: x rows through the x side, y rows through the y side
    tabs = ov_fill.ov_tables(mine, "cpu")
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    bank = torch.cat([
        ov_fill.bank_rows(tabs, "x", t["tok"], t["mk"], t["ik"], t["q"],
                          torch.from_numpy(hq), torch.from_numpy(lens)),
        ov_fill.bank_rows(tabs, "y", t["tok"], t["mk"], t["ik"], t["q"],
                          torch.from_numpy(hq), torch.from_numpy(lens)),
    ])
    # each pair one strip spanning its bounding band, as the JAX batch
    desc = bounding_band_desc(port_pairs(pairs))
    np.testing.assert_array_equal(desc[0], np.asarray(bpairs.base.member))
    np.testing.assert_array_equal(desc[1][:, 0], np.asarray(bpairs.base.d_lo))
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in common.items()}
    batch.update({k: torch.from_numpy(v) for k, v in zip(
        ("seg_d_lo", "seg_start", "seg_width", "j_off", "n_rows"), desc[1:])})
    batch.update(bank=bank, x_row=torch.tensor(x_row),
                 y_row=torch.tensor(y_row) + n)
    got, _ = _scores(mine, batch)
    _close(got, want, KERNEL)


def test_ov_fill_routes_by_device():
    """CPU tensors run the plain version (no launch counted); a device
    without a kernel raises instead of falling back."""
    _, mine = _tables(0, False)
    pairs = port_pairs(_read_pairs(np.random.default_rng(5), 2))
    inp = ov_fill.prepare(ov_fill.ov_tables(mine, "cpu"), overlap_bank_batch(
        pairs, mine, bounding_band_desc(pairs), "cpu"))
    before = ov_fill.ov_fill.launches
    out = ov_fill.ov_fill(**inp)
    assert ov_fill.ov_fill.launches == before
    assert out.shape == (2 + 2 * 1,) and out.dtype == torch.float32
    assert torch.equal(out, ov_fill.ov_fill_reference(**inp))
    meta = {k: v.to("meta") for k, v in inp.items()}
    with pytest.raises(RuntimeError, match="no kernel"):
        ov_fill.ov_fill(**meta)


@pytest.mark.parametrize("lpt", [1, 2, 4, 8, 16, None])
def test_ov_route_table(lpt):
    """K4's route is a pure function of the band's width: every width up to
    OV_WARP_MAX_LANES takes the warp route with the smallest lanes-a-thread
    whose warp (32 * lpt lanes) covers it (the widths 16*lpt+1 .. 32*lpt);
    every wider band up to OV_LANE_CAP takes the cluster route (lpt None:
    the widths past the cutover), its tiling (CTAs a pair, warps a CTA,
    lanes a thread) from OV_CLUSTER_TABLE, one the kernel has, covering the
    band with no whole tile past it; no route takes a wider band."""
    from quaff_tpu_torch.dp.fill_v2 import MAX_CLUSTER_CTAS, MAX_TILES

    cut = ov_fill.OV_WARP_MAX_LANES
    assert cut in (128, 256, 512)
    if lpt is None:
        widths = range(cut + 1, ov_fill.OV_LANE_CAP + 1)
        for W in widths:
            kind, (nct, warps, tl) = ov_fill.ov_route(W)
            assert kind == "cluster" and tl in ov_fill.OV_CLUSTER_LPTS
            assert warps <= ov_fill.ov_cluster_max_warps(tl)
            assert nct <= MAX_CLUSTER_CTAS and nct * warps <= MAX_TILES
            tiles = -(-W // (32 * tl))
            assert nct * warps >= tiles and (nct - 1) * warps < tiles
        with pytest.raises(ValueError, match="OV_LANE_CAP"):
            ov_fill.ov_route(ov_fill.OV_LANE_CAP + 1)
        return
    widths = range(16 * lpt + 1 if lpt > 1 else 1, 32 * lpt + 1)
    want = ("warp", lpt) if 32 * lpt <= cut else None
    assert len(widths) > 0
    for W in widths:
        got = ov_fill.ov_route(W)
        assert got == want if want else got[0] == "cluster"


def test_ov_fill_forced_route_on_cpu():
    """A route given to ov_fill must be one K4 has and cover the band, in
    a cluster of at most 8 CTAs; on CPU tensors every route runs the plain
    version and moves no launch count, cluster_launches included."""
    from test_torch_kernel_cuda import random_ov_inputs

    inp = random_ov_inputs(np.random.default_rng(3), 40, B=2, L=48,
                           device="cpu")
    ref = ov_fill.ov_fill_reference(**inp)
    counts = ("launches", "warp_launches", "cluster_launches")
    before = [getattr(ov_fill.ov_fill, k) for k in counts]
    for route in (None, ("warp", 2), ("warp", 16), ("cluster", (1, 1, 2)),
                  ("cluster", (2, 1, 2)), ("cluster", (1, 2, 8)),
                  ("cluster", (8, 1, 2))):
        assert torch.equal(ov_fill.ov_fill(**inp, route=route), ref)
    assert [getattr(ov_fill.ov_fill, k) for k in counts] == before
    for bad in (("warp", 1), ("warp", 3), ("block", None), ("block", 4),
                ("tile", None), ("cluster", (1, 1, 1)),
                ("cluster", (1, 1, 16)), ("cluster", (1, 17, 2)),
                ("cluster", (1, 9, 8)), ("cluster", (16, 1, 2)),
                ("cluster", (17, 1, 2)),
                ("cluster", None)):
        with pytest.raises(ValueError, match="no route"):
            ov_fill.ov_fill(**inp, route=bad)
