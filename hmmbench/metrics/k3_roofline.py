"""k3_roofline: K3's (bwd_counts) share of its roofline in the window, %.

As k2_roofline, with 106 operations a cell, and bytes: K2's store read
once, the inputs, and each pair's count table and scalar sums written.
"""

KERNEL = "bwd_counts"
# operations per in-envelope cell, counted from K3's cell update
OPS_PER_CELL = 106
# quaff's default orders: 4 x 4 x 94 match, 4 x 94 insert and 4 transition
# counts a pair, float32
COUNT_ENTRIES = 4 * 4 * 94 + 4 * 94 + 4


def read(ctx):
    if ctx.window is None or not ctx.chunks:
        return None
    seconds = ctx.window.kernel_seconds(KERNEL)
    if seconds <= 0:
        return None
    rl = ctx.roofline
    bound = 0.0
    for c in ctx.chunks:
        nbytes = rl.kernel_bytes(KERNEL, c["cells"], rl.input_bytes(
            c["x_lens"], c["y_lens"], rl.TABLE_BYTES), c["pairs"],
            COUNT_ENTRIES)
        bound += rl.bound_seconds(nbytes, OPS_PER_CELL * c["cells"],
                                  ctx.precision)[0]
    return 100.0 * bound / seconds
