"""Share of the traced window in which no device operation ran, in %."""


def read(ctx):
    if ctx.trace is None or not (ctx.trace.kernels or ctx.trace.copies):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
