"""Reading torch.profiler's trace of the window: device activity, its union,
the kernels by name, and what the host was doing while the card idled."""

from __future__ import annotations

import collections

# The port's E-step kernels by a part of their demangled names, the first
# match wins: a frozen copy of the K2/K3 rows of quaff_tpu_torch/prof/
# kernel_sass.py KERNEL_NAMES at the commit that added this benchmark.
# band_fill_cluster_kernel's STORE instantiations (<false, true, ...>) are
# K2's cluster route.
KERNELS = (
    ("band_fill_cluster_kernel<false, true,", ("fwd_store", "cluster")),
    ("fwd_store_warp_kernel<", ("fwd_store", "warp")),
    ("fwd_store_smem_kernel<true>", ("fwd_store", "global")),
    ("fwd_store_smem_kernel", ("fwd_store", "smem")),
    ("bwd_counts_warp_kernel<", ("bwd_counts", "warp")),
    ("bwd_counts_cluster_kernel<", ("bwd_counts", "cluster")),
    ("bwd_counts_smem_kernel<true>", ("bwd_counts", "global")),
    ("bwd_counts_smem_kernel", ("bwd_counts", "smem")),
    ("estep_reduce_kernel", ("estep_reduce", None)),
)

SPAN_PREFIX = "hmmbench."


def kernel_of(name: str):
    for part, owner in KERNELS:
        if part in name:
            return owner
    return None


def short_name(name: str) -> str:
    """A kernel's demangled name without its arguments."""
    return name.replace("(anonymous namespace)::", "").split("(")[0].strip()


def events(prof):
    """[(name, device, start_us, end_us)] of every event the profiler
    kept, device "CUDA" for work on the card."""
    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            dev = str(e.device_type()).rsplit(".", 1)[-1]
            s = e.start_ns() / 1e3
            out.append((e.name(), dev, s, s + e.duration_ns() / 1e3))
    except AttributeError:
        for e in prof.events():
            dev = str(e.device_type).rsplit(".", 1)[-1]
            out.append((e.name, dev, e.time_range.start, e.time_range.end))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Window:
    """The device's activity inside the traced window (the harness's
    `hmmbench.window` span)."""

    def __init__(self, evs):
        marks = [(s, e) for n, d, s, e in evs if n == SPAN_PREFIX + "window"]
        if not marks:
            raise RuntimeError("the trace holds no window span")
        self.lo, self.hi = marks[0]
        self.window_s = (self.hi - self.lo) * 1e-6
        # the harness's spans are mirrored on the card's timeline as
        # annotations: they are no device work
        self.device = [(n, max(s, self.lo), min(e, self.hi))
                       for n, d, s, e in evs
                       if d == "CUDA" and e > self.lo and s < self.hi
                       and not n.startswith(SPAN_PREFIX)]
        self.spans = [(n[len(SPAN_PREFIX):], s, e) for n, d, s, e in evs
                      if d == "CPU" and n.startswith(SPAN_PREFIX)
                      and n != SPAN_PREFIX + "window"]
        self.busy = _merge([(s, e) for _, s, e in self.device])
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6

    def kernel_seconds(self, kernel: str) -> float:
        return sum(e - s for n, s, e in self.device
                   if (kernel_of(n) or (None,))[0] == kernel) * 1e-6

    def top_ops(self, n=10):
        by = collections.Counter()
        for name, s, e in self.device:
            by[short_name(name)] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_by_host(self, n=10):
        """Idle seconds of the card in the window, by the innermost harness
        span the host was in at each gap's middle."""
        edges = [self.lo] + [x for iv in self.busy for x in iv] + [self.hi]
        by = collections.Counter()
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            inner = [(se - ss, name) for name, ss, se in self.spans
                     if ss <= mid <= se]
            by[min(inner)[1] if inner else "other"] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]
