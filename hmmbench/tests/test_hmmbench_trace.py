"""The trace reader on made-up profiler events: the window, the union of
device activity, kernels by name, and idle time by host span."""

import pytest

from hmmbench_tiny import BENCH  # noqa: F401  (puts hmmbench on the path)

from hb import trace

K2 = "void band_fill_cluster_kernel<false, true, 4>(signed char const*)"
K3 = ("void (anonymous namespace)::bwd_counts_smem_kernel<false>"
      "(signed char const*)")
EVENTS = [
    ("hmmbench.window", "CPU", 100.0, 1100.0),
    ("hmmbench.layout", "CPU", 100.0, 300.0),
    ("hmmbench.mstep", "CPU", 800.0, 1000.0),
    ("hmmbench.estep", "CPU", 100.0, 800.0),
    (K2, "CUDA", 300.0, 500.0),
    (K3, "CUDA", 450.0, 700.0),          # overlaps K2: counted once
    ("Memcpy HtoD", "CUDA", 50.0, 150.0),  # starts before the window
    (K2, "CUDA", 1050.0, 1200.0),          # ends after it
    ("aten::add", "CPU", 300.0, 310.0),
    # a harness span mirrored on the card's timeline: no device work
    ("hmmbench.estep", "CUDA", 100.0, 800.0),
]


def test_window_busy_and_kernels():
    w = trace.Window(EVENTS)
    assert w.window_s == pytest.approx(1000e-6)
    # busy: [100,150] + [300,700] + [1050,1100]
    assert w.busy_s == pytest.approx(500e-6)
    assert w.kernel_seconds("fwd_store") == pytest.approx(250e-6)
    assert w.kernel_seconds("bwd_counts") == pytest.approx(250e-6)
    assert trace.kernel_of(K2) == ("fwd_store", "cluster")
    assert trace.kernel_of("void band_fill_cluster_kernel<false, false, 4>") \
        is None
    names = [n for n, _ in w.top_ops()]
    assert names[0] == "void band_fill_cluster_kernel<false, true, 4>"
    assert names[1] == "void bwd_counts_smem_kernel<false>"


def test_idle_by_host_span():
    w = trace.Window(EVENTS)
    idle = dict(w.idle_by_host())
    # gaps [150,300] in layout, [700,1050]: mid 875 in mstep
    assert idle == pytest.approx({"layout": 150e-6, "mstep": 350e-6})
    assert sum(idle.values()) == pytest.approx(w.window_s - w.busy_s)


def test_no_window_span_raises():
    with pytest.raises(RuntimeError):
        trace.Window(EVENTS[1:])
