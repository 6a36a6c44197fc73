"""device_idle_pct: the share of the traced window in which nothing ran on
the card, 100 x (1 - the union of device activity intervals / the window),
from torch.profiler's trace."""


def read(ctx):
    if ctx.window is None or ctx.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
