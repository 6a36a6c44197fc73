"""mstep_s_per_iter: seconds of M-step a window E-step carries: the
harness's spans around model/params.QuaffParamCounts.fit and
QuaffParams.fit_ref_seqs (host work, on the host's clock), summed over
the window and divided by the E-steps started in it."""


def read(ctx):
    s = ctx.spans.get("mstep", 0.0)
    if not ctx.esteps or s <= 0:
        return None
    return s / ctx.esteps
