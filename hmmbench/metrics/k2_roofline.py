"""k2_roofline: K2's (fwd_store) share of its roofline in the window, %.

Time: the device time of the kernels whose names are K2's (any route), in
the traced window.  Bound: for each chunk the window's E-steps gave the
fused E-step, the larger of its bytes over the HBM rate and its operations
over the peak of the configuration's stated precision (hb/roofline.py);
summed over the chunks.  Cells are the chunk's in-envelope cells, never
lanes.
"""

KERNEL = "fwd_store"
# operations per in-envelope cell, counted from K2's cell update (a
# log-add-exp counts 6: max, subtract, abs, exp, log1p, add)
OPS_PER_CELL = 39


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
            c["x_lens"], c["y_lens"], rl.TABLE_BYTES), c["pairs"], 0)
        bound += rl.bound_seconds(nbytes, OPS_PER_CELL * c["cells"],
                                  ctx.precision)[0]
    return 100.0 * bound / seconds
