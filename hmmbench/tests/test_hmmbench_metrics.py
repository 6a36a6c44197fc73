"""train_kb_per_s, the frozen operation and byte counts, and the metric
readers on a made-up context."""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from hmmbench_tiny import BENCH

from hb import harness, roofline


def test_rate_counts_only_completed_fits():
    t0 = time.perf_counter()
    calls = []

    def do_fit(k):
        calls.append(k)
        time.sleep(0.02)
        if k == 2:
            raise harness.WindowClosed()  # still running as the window closed
        return dict(set=k % 2, esteps=[0] * (3 + k), msteps=[], rc=0)

    fits = harness.window(do_fit, t0, 10.0)
    assert calls == [0, 1, 2] and len(fits) == 2
    fits[1]["rc"] = 1  # a fit that failed counts in neither
    rate = harness.train_kb_per_s(fits, [1000, 3000], t0)
    assert rate == pytest.approx(1000 * 3 / 1e3 / (fits[0]["end"] - t0))
    fits[1]["rc"] = 0
    rate = harness.train_kb_per_s(fits, [1000, 3000], t0)
    assert rate == pytest.approx((3 + 12) / (fits[1]["end"] - t0))


def test_window_stops_when_closed():
    t0 = time.perf_counter() - 1.0
    assert harness.window(lambda k: {}, t0, 0.5) == []


def test_cells_from_envelopes_not_lanes():
    # a full envelope: X x Y cells, over X + Y - 1 diagonals (lanes)
    x, y = 700, 300
    full = np.arange(1 - y, x)
    assert roofline.envelope_cells(x, y, full) == x * y
    # a band of 11 diagonals about the main one: each diagonal's cells
    band = np.arange(-5, 6)
    want = sum(min(y, x - d) - max(1, 1 - d) + 1 for d in band)
    assert roofline.envelope_cells(x, y, band) == want < 11 * y


def test_float64_peak_for_float64_cells():
    ops = 1e12
    t64, what = roofline.bound_seconds(0, ops, "float64")
    t32, _ = roofline.bound_seconds(0, ops, "float32")
    assert what == "operations"
    assert t64 == pytest.approx(ops / 34e12)
    assert t64 / t32 == pytest.approx(67 / 34)
    assert roofline.bound_seconds(3.35e12, 1, "float64") == (1.0, "bytes")


class _Win:
    window_s, busy_s = 2.0, 1.5

    @staticmethod
    def kernel_seconds(kernel):
        return {"fwd_store": 0.5, "bwd_counts": 0.8}[kernel]


def _ctx(**kw):
    chunk = dict(pairs=2, cells=2 * 48502 * 3000, x_lens=[48502] * 2,
                 y_lens=[3000] * 2)
    base = dict(window=_Win(), chunks=[chunk], pairs=8, esteps=4,
                launches={"fwd_store.launches": 4},
                spans={"layout": 0.4, "upload": 0.2, "mstep": 0.4},
                precision="float64", roofline=roofline)
    base.update(kw)
    return SimpleNamespace(**base)


def test_readers():
    read = {n: harness.load_metric(BENCH, n) for n in (
        "k2_roofline", "k3_roofline", "device_idle_pct",
        "estep_pairs_per_launch", "layout_s_per_iter", "mstep_s_per_iter")}
    ctx = _ctx()
    cells = 2 * 48502 * 3000
    k2_bytes = 12 * cells + 2 * 48502 + 16 * 6000 + 64 + \
        roofline.TABLE_BYTES + 8
    assert read["k2_roofline"](ctx) == pytest.approx(
        100 * k2_bytes / 3.35e12 / 0.5)
    assert 0 < read["k3_roofline"](ctx) < 100
    assert read["device_idle_pct"](ctx) == pytest.approx(25.0)
    assert read["estep_pairs_per_launch"](ctx) == 2.0
    assert read["layout_s_per_iter"](ctx) == pytest.approx(0.1)
    assert read["mstep_s_per_iter"](ctx) == pytest.approx(0.1)
    # nothing to read: no value, never 0
    empty = _ctx(window=None, chunks=[], pairs=0, esteps=0, launches={},
                 spans={})
    assert all(r(empty) is None for r in read.values())
