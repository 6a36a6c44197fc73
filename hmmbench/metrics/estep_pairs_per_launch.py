"""estep_pairs_per_launch: pairs handed to the fused E-step
(dp/estep.estep_fused_multi) in the window over K2's launches there
(the port's fwd_store.launches counter): a count that repeats exactly."""


def read(ctx):
    launches = ctx.launches.get("fwd_store.launches", 0)
    if not launches or not ctx.pairs:
        return None
    return ctx.pairs / launches
