"""layout_s_per_iter: host seconds a window E-step spends laying out its
chunks: the harness's spans around dp/engine.PairBatch.build_packed, on
the host's clock with no synchronisation (the layout is host work that
the card can run kernels beside), summed over the window and divided by
the E-steps started in it."""


def read(ctx):
    s = ctx.spans.get("layout", 0.0)
    if not ctx.esteps or s <= 0:
        return None
    return s / ctx.esteps
