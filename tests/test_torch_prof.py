"""The speed-of-light probes of the port (quaff_tpu_torch/prof/) on the CPU.

The plain chains are held against the TPU probes' own kernel bodies, taken
from tools/prof/roofline_probe.py (chain_kernel, nested in main) and
tools/prof/sol_transcendental.py (raw_lse, raw_lse_log, chain_kernel) by
their syntax tree and run with interpret=True at B=8, W=128, GRID=3, and at
W=600, a width past a warp that no lane tiling divides, so that the cyclic
roll over a ragged band is pinned.
Tolerances: add_max and roll_add bitwise (add, max and a lane move are
exact and run in the same order); the log-add-exp chains atol 1e-6, a
margin for libm differences between XLA's CPU kernels and PyTorch's.
The CUDA kernel itself is tested on the card (test_torch_kernel_cuda.py).
"""

import ast
import functools
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from quaff_tpu_torch.dp import fill_v2
from quaff_tpu_torch.prof import chains, roofline_probe, sol_transcendental

REPO = pathlib.Path(__file__).resolve().parent.parent
B, W, GRID, ITERS = 8, 128, 3, 4


def _functions(path, names, inside=None):
    """The source of the top-level functions `names` of `path` (or of the
    functions nested in the function `inside`)."""
    tree = ast.parse(path.read_text())
    body = tree.body
    if inside is not None:
        body = next(n for n in body
                    if isinstance(n, ast.FunctionDef) and n.name == inside).body
    found = {n.name: n for n in body if isinstance(n, ast.FunctionDef)}
    return ast.unparse(ast.Module([found[n] for n in names], []))


@functools.lru_cache(maxsize=None)
def _tpu_probes(width=W):
    """The TPU probes' chain_kernel factories for [B, width] blocks,
    executed with a pallas shim that runs pallas_call in interpret mode."""
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, when=pl.when, program_id=pl.program_id)
    env = {"jax": jax, "jnp": jnp, "pl": shim, "pltpu": pltpu, "B": B,
           "W": width, "GRID": GRID}
    p1 = dict(env)
    exec(_functions(REPO / "tools/prof/roofline_probe.py", ["chain_kernel"],
                    inside="main"), p1)
    p2 = dict(env)
    exec(_functions(REPO / "tools/prof/sol_transcendental.py",
                    ["raw_lse", "raw_lse_log", "chain_kernel"]), p2)
    return p1, p2


def _tpu_chain(op, a, b):
    p1, p2 = _tpu_probes(a.shape[1])
    if op in ("add_max", "roll_add"):
        run = p1["chain_kernel"](ITERS, op == "roll_add")
    else:
        f = {"lse_guarded": jnp.logaddexp, "raw_lse": p2["raw_lse"],
             "raw_lse_log": p2["raw_lse_log"]}[op]
        run = p2["chain_kernel"](ITERS, f)
    return np.asarray(run((jnp.asarray(a), jnp.asarray(b))))


def _check_plain_chain(op, width):
    if op in ("add_max", "roll_add"):
        a, b = (t.numpy() for t in roofline_probe.p1_inputs(B, width, "cpu"))
    else:
        a, b = (t.numpy()
                for t in sol_transcendental.p2_inputs(B, width, "cpu"))
    want = _tpu_chain(op, a, b)
    got = chains.chain_reference(op, torch.from_numpy(a), torch.from_numpy(b),
                                 GRID, ITERS).numpy()
    if op in ("add_max", "roll_add"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("op", chains.OPS)
def test_plain_chain_matches_tpu_probe(op):
    _check_plain_chain(op, W)


@pytest.mark.parametrize("op", chains.OPS)
def test_plain_chain_matches_tpu_probe_ragged_band(op):
    """W=600: the cluster layout's 1 x 5 x 4 leaves 40 lanes of its last
    tile past the band, and roll_add's lane 0 takes lane 599."""
    assert chains.chain_route(600) == ("cluster", (1, 5, 4))
    _check_plain_chain(op, 600)


@pytest.mark.parametrize("W_, kind", [
    (1, "warp"), (32, "warp"), (33, "warp"), (512, "warp"),
    (513, "cluster"), (16384, "cluster"), (16385, "smem"), (221184, "smem"),
    (221185, "global")])
def test_chain_layout_is_k1s_route(W_, kind):
    """The chain's layout at each route edge is K1's route and tiling for a
    band of that width (fill_v2.fill_route), so a probe step there runs at
    K1's tiling; the global tier's slab holds every CTA's run of every row,
    12 bytes (x, a and b) a lane."""
    route = chains.chain_route(W_)
    assert route == fill_v2.fill_route(W_)
    assert route[0] == kind
    if kind == "warp":
        assert W_ <= 32 * route[1] and (route[1] == 1 or W_ > 16 * route[1])
    else:
        nct, warps, lpt = route[1]
        assert W_ <= nct * warps * 32 * lpt
        assert chains.slab_bytes(3, route[1]) == 3 * nct * warps * 32 * lpt * 12


def test_chain_refuses_what_the_kernel_does_not_take():
    """The wrapper's checks run on every device, the CPU's too: a row of no
    lane, a wrong dtype, mismatched shapes, a tensor that is not [B, W],
    negative steps."""
    a, b = roofline_probe.p1_inputs(2, 40, "cpu")
    with pytest.raises(ValueError, match="W >= 1"):
        chains.chain("roll_add", a[:, :0], b[:, :0], 1, 1)
    with pytest.raises(ValueError, match="float32"):
        chains.chain("add_max", a.double(), b, 1, 1)
    with pytest.raises(ValueError, match="float32"):
        chains.chain("add_max", a, b, 1, 1, x0=a.half())
    with pytest.raises(ValueError, match="shape"):
        chains.chain("add_max", a, b[:, :39].contiguous(), 1, 1)
    with pytest.raises(ValueError, match="shape"):
        chains.chain("raw_lse", a, b, 1, 1, x0=a[:1].contiguous())
    with pytest.raises(ValueError, match=r"\[B, W\]"):
        chains.chain("add_max", a[0], b[0], 1, 1)
    with pytest.raises(ValueError, match=">= 0"):
        chains.chain("add_max", a, b, -1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        chains.chain("add_max", a.t().contiguous().t(), b, 1, 1)


def test_chain_routes_cpu_tensors_to_plain_version():
    a, b = roofline_probe.p1_inputs(4, 32, "cpu")
    before = sum(chains.chain.launches.values())
    for op in chains.OPS:
        assert torch.equal(chains.chain(op, a, b, 2, 5),
                           chains.chain_reference(op, a, b, 2, 5))
    x0 = torch.zeros_like(a)
    assert torch.equal(chains.chain("raw_lse", a, b, 1, 1, x0=x0),
                       chains.chain_reference("raw_lse", a, b, 1, 1, x0=x0))
    assert sum(chains.chain.launches.values()) == before
    with pytest.raises(ValueError, match="unknown op"):
        chains.chain("exp", a, b, 1, 1)


def test_marginal():
    # 0.5 ns a [2, 4] step: 64 more iterations over GRID 8 take 256 ns more
    step, rate = chains.marginal(1e-6, 1e-6 + 256e-9, 64, 128, 8, 2, 4, 2)
    assert step == pytest.approx(0.5e-9)
    assert rate == pytest.approx(2 * 2 * 4 / 0.5e-9)


def test_timing_refuses_cpu_tensors():
    a, b = roofline_probe.p1_inputs(2, 32, "cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        chains.cuda_time(chains.chain, "add_max", a, b, 1, 1)
    with pytest.raises(RuntimeError, match="CUDA card"):
        chains.cuda_time(lambda: None)


def test_element_check_on_the_plain_versions():
    """P2's element check runs on the plain versions: the guarded lse
    equals raw_lse bit for bit (the same operations; the guard only acts
    where both operands are sentinels, and picks the same value there) and
    is within a few ulps of torch.logaddexp (another vectorised exp and
    log1p on the CPU)."""
    check = sol_transcendental.element_check("cpu")
    assert check["raw_lse"] == {"bitwise": True, "max_ulps": 0}
    assert check["torch.logaddexp"]["max_ulps"] <= 4
    assert set(check) == {"torch.logaddexp", "raw_lse", "raw_lse_log"}


def test_ulps():
    x = torch.tensor([1.0, -2.0, 0.0], dtype=torch.float32)
    y = torch.nextafter(x, torch.full_like(x, -np.inf))
    assert sol_transcendental.ulps(x, x) == 0
    assert sol_transcendental.ulps(x, y) == 1


def test_fill_parts_run_through_plain_k1(monkeypatch):
    """Parts (b) and (c) at a toy size (the read cut to at most 64 rows,
    B=2) through K1's plain version, timed by a stand-in clock that charges
    1 ms + 2 us a row: the fits find that line again."""
    def clock(fn, inp, v2, runs=3):
        out = fn(inp, v2)
        assert out.device.type == "cpu" and bool(torch.isfinite(out[:2]).all())
        return 1e-3 + 2e-6 * inp["keys"].shape[1]

    monkeypatch.setattr(roofline_probe, "cuda_time", clock)
    before = fill_v2.band_fill.launches
    fills = roofline_probe.fill_rates([2], "cpu", max_rows=64)
    assert [r["B"] for r in fills] == [2]
    assert fills[0]["cells"] > 0
    assert fills[0]["cells_per_s"] == fills[0]["cells"] / fills[0]["s"]
    pts, (slope, intercept), by_width = roofline_probe.row_costs(
        [32, 48, 64], 2, "cpu")
    assert [p["rows"] for p in pts] == [32, 48, 64]
    assert slope == pytest.approx(2e-6)
    assert intercept == pytest.approx(1e-3)
    # 48 and 64 rows pack to one width, 32 rows to another
    assert pts[1]["W"] == pts[2]["W"] != pts[0]["W"]
    assert list(by_width) == [pts[1]["W"]]
    assert by_width[pts[1]["W"]] == pytest.approx((2e-6, 1e-3))
    assert fill_v2.band_fill.launches == before


SASS = """
	code for sm_90a
		Function : _Z4demoPf
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
        /*0020*/                   FADD R2, R0, R0 ;
        /*0030*/                   STL [R1], R2 ;
        /*0040*/                   ISETP.GE.AND P0, PT, R0, 0x4, PT ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   FADD R4, R3, R3 ;
        /*0070*/              @!P0 BRA 0x60 ;
        /*0080*/                   EXIT ;
.L_x_0:
        /*0090*/              @P1 BRA `(.L_x_0) ;
        /*00a0*/                   BRA 0x10 ;
		Function : _Z5otherv
        /*0000*/                   EXIT ;
"""
RES = """
 Function _Z4demoPf:
  REG:12 STACK:0 SHARED:128 LOCAL:0 CONSTANT[0]:364 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _Z5otherv:
  REG:4 STACK:8 SHARED:0 LOCAL:16 CONSTANT[0]:352 TEXTURE:0 SURFACE:0 SAMPLER:0
"""
PTXAS = """ptxas info    : Compiling entry function '_Z4demoPf' for 'sm_90a'
ptxas info    : Function properties for _Z4demoPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers, 364 bytes cmem[0]
ptxas info    : Compiling entry function '_Z5otherv' for 'sm_90a'
ptxas info    : Function properties for _Z5otherv
    8 bytes stack frame, 16 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 4 registers, used 0 barriers, 352 bytes cmem[0]
"""


def test_kernel_sass_parsers():
    """kernel_sass reads cuobjdump's SASS (addresses and labels as branch
    targets), its resource usage and ptxas's report: the longest loop is
    the span of the backward branch at 0x50 to 0x20 (4 instructions, one
    a local store); a forward branch and a one-instruction self-loop are
    shorter, and the unpredicated jump back from 0xa0 is no loop."""
    from quaff_tpu_torch.prof import kernel_sass

    funcs = kernel_sass.parse_sass(SASS)
    assert list(funcs) == ["_Z4demoPf", "_Z5otherv"]
    demo = funcs["_Z4demoPf"]
    assert len(demo) == 11
    assert demo[5][2] == 0x20 and demo[9][2] == 0x90 and demo[10][2] == 0x10
    assert kernel_sass.row_loop(demo) == (4, 1)
    assert kernel_sass.row_loop(funcs["_Z5otherv"]) == (0, 0)
    assert kernel_sass.parse_resources(RES) == {
        "_Z4demoPf": (12, 0, 128, 0), "_Z5otherv": (4, 8, 0, 16)}
    assert kernel_sass.parse_ptxas(PTXAS) == {
        "_Z4demoPf": (12, 0, 0), "_Z5otherv": (4, 16, 12)}


@pytest.mark.parametrize("name, owner", [
    ("void (anonymous namespace)::fwd_store_smem_kernel<true>(signed char "
     "const*, int, int4 const*, int)", ("fwd_store", "global")),
    ("void (anonymous namespace)::bwd_counts_smem_kernel<true>(signed "
     "char const*, int)", ("bwd_counts", "global")),
    ("void (anonymous namespace)::band_fill_smem_kernel<true, false>(signed "
     "char const*, int)", ("band_fill", "global")),
    ("void band_fill_smem_kernel<true, true>", ("band_fill", "global")),
    ("void band_fill_warp_kernel<false, 8>", ("band_fill", "warp")),
    ("void (anonymous namespace)::band_fill_cluster_kernel<true, 16>(signed "
     "char const*, int)", ("band_fill", "cluster")),
    ("void (anonymous namespace)::band_fill_cluster_kernel<true, false, 8>("
     "signed char const*, int)", ("band_fill", "cluster")),
    ("void (anonymous namespace)::band_fill_cluster_kernel<false, true, 16>("
     "signed char const*, int)", ("fwd_store", "cluster")),
    ("void (anonymous namespace)::bwd_counts_cluster_kernel<4>(signed char "
     "const*, int)", ("bwd_counts", "cluster")),
    ("void (anonymous namespace)::band_fill_cluster_kernel<false, true, 16, "
     "1>(signed char const*, int)", ("fwd_store", "cluster")),
    ("void (anonymous namespace)::bwd_counts_cluster_kernel<16, 1>(signed "
     "char const*, int)", ("bwd_counts", "cluster")),
    ("(anonymous namespace)::fwd_store_smem_kernel<false>(signed char "
     "const*, int)", ("fwd_store", "smem")),
    ("void (anonymous namespace)::fwd_store_smem_kernel(signed char const*, "
     "int)", ("fwd_store", "smem")),
    ("void (anonymous namespace)::bwd_counts_smem_kernel(signed char "
     "const*, int)", ("bwd_counts", "smem")),
    ("void (anonymous namespace)::fwd_store_warp_kernel<8>(signed char "
     "const*, int)", ("fwd_store", "warp")),
    ("void fwd_store_warp_kernel<16>", ("fwd_store", "warp")),
    ("void (anonymous namespace)::bwd_counts_warp_kernel<4>(signed char "
     "const*, int)", ("bwd_counts", "warp")),
    ("(anonymous namespace)::bwd_counts_smem_kernel<false>(signed char "
     "const*, int)", ("bwd_counts", "smem")),
    ("estep_reduce_kernel", ("estep_reduce", None)),
    ("void ov_fill_warp_kernel<true, 4>", ("ov_fill", "warp")),
    ("void (anonymous namespace)::ov_fill_cluster_kernel<false, 8>(float "
     "const*, int)", ("ov_fill", "cluster")),
    ("void (anonymous namespace)::sol_warp_kernel<1, 8, 6>(float const*, "
     "float const*)", ("sol_chain", "warp")),
    ("void sol_cluster_kernel<0, 8>", ("sol_chain", "cluster")),
    ("void (anonymous namespace)::sol_smem_kernel<false, 1>(float const*, "
     "int)", ("sol_chain", "smem")),
    ("void sol_smem_kernel<true, 2>", ("sol_chain", "global")),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
    ("void (anonymous namespace)::band_fill_smem_kernel<false, true>(signed "
     "char const*, int)", ("band_fill", "smem")),
    ("void band_fill_smem_kernel<false, false>", ("band_fill", "smem")),
])
def test_kernel_of_names_each_kernel(name, owner):
    """kernel_of attributes a kernel's demangled name (as torch.profiler
    or c++filt prints it) to the wrapper that launches it and its route:
    K2's cluster route is K1's cluster fill with STORE set, its warp route
    and K3's have kernels of their own, as have K3's and K4's cluster
    routes and K1's, K2's and K3's smem routes (their instantiations with
    GLOBAL true, the first argument, their global tier); the probes' chain
    kernel has one a layout of K1's; a PyTorch kernel is none of the
    port's."""
    from quaff_tpu_torch.prof import kernel_sass

    assert kernel_sass.kernel_of(name) == owner


SASS_CTRL = """
		Function : _Z4loopv
        /*0000*/                   S2R R0, SR_TID.X ;     /* 0x0000000000007919 */
                                                          /* 0x000e220000002100 */
        /*0010*/                   FADD R2, R0, R0 ;      /* 0x0000000000027221 */
                                                          /* 0x001fc80000000000 */
        /*0020*/                   FSETP.GEU.AND P0, PT, R2, 1, PT ; /* 0x3f8000000200780b */
                                                          /* 0x000fda0003f0e000 */
        /*0030*/              @!P0 BRA 0x10 ;             /* 0xfffffffc00008947 */
                                                          /* 0x000fea000383ffff */
        /*0040*/                   EXIT ;                 /* 0x000000000000794d */
                                                          /* 0x000fea0003800000 */
"""


def test_kernel_sass_stall_cycles():
    """parse_stalls reads each instruction's stall count (bits 41-44 of its
    control word): the loop 0x10-0x30 waits 4 + 13 + 5 cycles; loop_span
    finds that loop."""
    from quaff_tpu_torch.prof import kernel_sass

    stalls = kernel_sass.parse_stalls(SASS_CTRL)
    assert stalls == {"_Z4loopv": {0x0: 1, 0x10: 4, 0x20: 13, 0x30: 5,
                                   0x40: 5}}
    instrs = kernel_sass.parse_sass(SASS_CTRL)["_Z4loopv"]
    assert kernel_sass.loop_span(instrs) == (0x10, 0x30)
    assert kernel_sass.row_loop(instrs) == (3, 0)


def test_f32_chain_global_band_is_the_card_tests_recipe():
    """prof/f32_chain.py's inputs are the card tests' global long-deletion
    bands (random_fill_inputs drawn in the same order), so its errors are
    the card tests' inputs' errors."""
    import numpy as np
    import torch

    from quaff_tpu_torch.prof import f32_chain
    from test_torch_kernel_cuda import _tables, random_fill_inputs

    W = 600
    got, _ = f32_chain.global_band(W, W + 7)
    want, _ = random_fill_inputs(np.random.default_rng(W + 7),
                                 _tables("packed"), W, B=4, Lx=W // 2 + 64,
                                 Ly=min(W // 4, 1024), local=False,
                                 device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("wide", [False, True], ids=["seq", "wide"])
def test_f32_chain_block_chain_is_the_chain(wide):
    """The probe's block-route delete chain (1024 threads of 3 lanes: each
    thread's composition, the warp scan, the scan of the warp totals, the
    replay) computes x[w] = lse(x[w-1] + c[w], b[w]) with invalid lanes
    resetting it, within float32 rounding of the chain run lane by lane in
    float64, in both its forms."""
    import numpy as np
    import torch

    from quaff_tpu_torch.dp import fill_v2
    from quaff_tpu_torch.prof import f32_chain

    rng = np.random.default_rng(3)
    B, W = 2, 3000
    valid = rng.random((B, W)) > 0.01
    b = np.where(valid, rng.normal(-5.0, 3.0, (B, W)), fill_v2.NEG_INF)
    c = np.where(valid, -0.53, fill_v2.NEG_INF)
    got = f32_chain.block_chain(torch.tensor(c, dtype=torch.float32),
                                torch.tensor(b, dtype=torch.float32), wide)
    x = np.full(B, -np.inf)
    want = np.empty((B, W))
    for w in range(W):
        x = np.where(valid[:, w], np.logaddexp(x + c[:, w], b[:, w]),
                     fill_v2.NEG_INF)
        want[:, w] = x
    g = got.double().numpy()
    assert np.array_equal(g[valid] > fill_v2.NEG_INF / 2,
                          np.ones(int(valid.sum()), bool))
    np.testing.assert_allclose(g[valid], want[valid], rtol=0, atol=1e-4)


@pytest.mark.parametrize("W", [4097, 6000, 12070, 16384, 22136, 98304,
                               131072])
def test_estep_sweep_tilings_take_the_table_row(W):
    """prof/estep_sweep.py's routes at a band past 4096 lanes: each one of
    the route estep_route picks that the kernel takes (K3's cluster route
    in two levels, K2's smem route; past 65536 lanes both smem tiers at 4,
    8 and 16 warps a CTA), one a count of warps a CTA at each lanes a
    thread, the table's own route among them, and beside K3's two-level
    fold both smem tiers (its float64 cells against the fold's float32
    ones); its batch is phase 2b's wide recipe (8 pairs whose bands span
    all W lanes)."""
    from quaff_tpu_torch.dp import estep
    from quaff_tpu_torch.prof import estep_sweep

    for k in ("fwd_store", "bwd_counts"):
        kind, tiling = estep.estep_route(W, k)
        if W <= 65536:
            assert kind == ("smem" if k == "fwd_store" else "cluster")
        ts = estep_sweep.tilings(W, k)
        assert (kind, tiling) in ts
        assert len(set(ts)) == len(ts)
        if W <= 65536:
            own = [r for r in ts if r[0] == kind]
            assert len({r[1][1:] for r in own}) == len(own)
            assert {r[0] for r in ts} - {kind} == (
                {"smem", "global"} if kind == "cluster" else set())
        else:
            assert {r[0] for r in ts} <= {"smem", "global"}
            assert {r[1][1] for r in ts} == {4, 8, 16}
        for r in ts:
            assert estep.estep_route_ok(W, r, k)
            if r[0] == "cluster":
                assert estep.cluster_mode(W, r[1]) == estep.TWO_FOLD
    if W == 4097:
        pb, _ = estep_sweep.wide_batch(1000)
        assert pb.member.shape == (8, 1000)
        assert bool(pb.member[:, 1:-1].all())  # all but the halo lanes
