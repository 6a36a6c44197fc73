"""Operations, bytes and the card's peaks, for the kernels' roofline shares.

A frozen copy of chip_smoke.py's _bound (chip_smoke.py:456-468 at the
commit that added this benchmark; its OPS_PER_CELL rows for K2 and K3 sit
in metrics/k2_roofline.py and k3_roofline.py), with one correction: the operation bound takes the peak of the precision the cells
are computed in (chip_smoke.py divides every route by the float32 peak,
also K2's and K3's float64-cell routes).  Cells are the in-envelope (i, j)
cells of the pairs a kernel was given, never its lanes, so the count is
the same whatever route or tiling computes them.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at its 700 W limit: float64 and
# float32 outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# score tables of quaff's default orders (match order 1, gap order 0):
# match [4, 4, 94], insert [4, 94] and 8 transitions, float32
TABLE_BYTES = 4 * (4 * 4 * 94 + 4 * 94 + 8)
# bytes per cell K2 stores and K3 reads back: the M, I and D rows, float32
STORE_BYTES_PER_CELL = 12


def envelope_cells(x_len: int, y_len: int, diagonals) -> int:
    """Cells (i, j), 1 <= i <= x_len, 1 <= j <= y_len, on the member
    diagonals d = i - j of an envelope."""
    d = np.asarray(diagonals, np.int64)
    lo = np.maximum(1, 1 - d)
    hi = np.minimum(y_len, x_len - d)
    return int(np.sum(np.maximum(hi - lo + 1, 0)))


def input_bytes(x_lens, y_lens, table_bytes: int) -> int:
    """What a kernel reads once besides the store: each pair's ref tokens
    (1 byte), each row's keys (16 bytes), its 32 bytes of pair metadata,
    and the score tables."""
    return int(np.sum(x_lens) + 16 * np.sum(y_lens) + 32 * len(x_lens)
               + table_bytes)


def kernel_bytes(kernel: str, cells: int, inputs: int, pairs: int,
                 count_entries: int) -> int:
    """K2 ("fwd_store"): its inputs and the rows it stores; K3
    ("bwd_counts"): its inputs, the store read once, and each pair's count
    table and five scalar sums written (float32)."""
    store = STORE_BYTES_PER_CELL * cells
    if kernel == "fwd_store":
        return inputs + store + 4 * pairs
    return inputs + store + 4 * pairs * (count_entries + 5)


def bound_seconds(nbytes: float, ops: float, precision: str):
    """(least seconds the card could take, what bounds it)."""
    t_b, t_o = nbytes / PEAK_BYTES, ops / PEAK_FLOPS[precision]
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
