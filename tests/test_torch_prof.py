"""The speed-of-light probes of the port (quaff_tpu_torch/prof/) on the CPU.

The plain chains are held against the TPU probes' own kernel bodies, taken
from tools/prof/roofline_probe.py (chain_kernel, nested in main) and
tools/prof/sol_transcendental.py (raw_lse, raw_lse_log, chain_kernel) by
their syntax tree and run with interpret=True at B=8, W=128, GRID=3.
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
def _tpu_probes():
    """The TPU probes' chain_kernel factories, executed with a pallas shim
    that runs pallas_call in interpret mode."""
    shim = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, when=pl.when, program_id=pl.program_id)
    env = {"jax": jax, "jnp": jnp, "pl": shim, "pltpu": pltpu, "B": B,
           "W": W, "GRID": GRID}
    p1 = dict(env)
    exec(_functions(REPO / "tools/prof/roofline_probe.py", ["chain_kernel"],
                    inside="main"), p1)
    p2 = dict(env)
    exec(_functions(REPO / "tools/prof/sol_transcendental.py",
                    ["raw_lse", "raw_lse_log", "chain_kernel"]), p2)
    return p1, p2


def _tpu_chain(op, a, b):
    p1, p2 = _tpu_probes()
    if op in ("add_max", "roll_add"):
        run = p1["chain_kernel"](ITERS, op == "roll_add")
    else:
        f = {"lse_guarded": jnp.logaddexp, "raw_lse": p2["raw_lse"],
             "raw_lse_log": p2["raw_lse_log"]}[op]
        run = p2["chain_kernel"](ITERS, f)
    return np.asarray(run((jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("op", chains.OPS)
def test_plain_chain_matches_tpu_probe(op):
    if op in ("add_max", "roll_add"):
        a, b = (t.numpy() for t in roofline_probe.p1_inputs(B, W, "cpu"))
    else:
        a, b = (t.numpy() for t in sol_transcendental.p2_inputs(B, W, "cpu"))
    want = _tpu_chain(op, a, b)
    got = chains.chain_reference(op, torch.from_numpy(a), torch.from_numpy(b),
                                 GRID, ITERS).numpy()
    if op in ("add_max", "roll_add"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


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
    ("void (anonymous namespace)::band_fill_kernel<false, true>(signed char "
     "const*, int, int4 const*, int)", ("fwd_store", "block")),
    ("void band_fill_kernel<true, false>", ("band_fill", "block")),
    ("void band_fill_warp_kernel<false, 8>", ("band_fill", "warp")),
    ("void (anonymous namespace)::band_fill_cluster_kernel<true, 16>(signed "
     "char const*, int)", ("band_fill", "cluster")),
    ("void (anonymous namespace)::fwd_store_warp_kernel<8>(signed char "
     "const*, int)", ("fwd_store", "warp")),
    ("void fwd_store_warp_kernel<16>", ("fwd_store", "warp")),
    ("void (anonymous namespace)::bwd_counts_warp_kernel<4>(signed char "
     "const*, int)", ("bwd_counts", "warp")),
    ("(anonymous namespace)::bwd_counts_kernel(signed char const*, int)",
     ("bwd_counts", "block")),
    ("estep_reduce_kernel", ("estep_reduce", None)),
    ("void ov_fill_warp_kernel<true, 4>", ("ov_fill", "warp")),
    ("void (anonymous namespace)::ov_fill_cluster_kernel<false, 8>(float "
     "const*, int)", ("ov_fill", "cluster")),
    ("void sol_chain_kernel<2>", ("sol_chain", None)),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
])
def test_kernel_of_names_each_kernel(name, owner):
    """kernel_of attributes a kernel's demangled name (as torch.profiler
    or c++filt prints it) to the wrapper that launches it and its route:
    K2's block route is K1's block fill with STORE set, its warp route
    and K3's have kernels of their own, as have K1's and K4's cluster
    routes; a PyTorch kernel is none of the port's."""
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
