"""Device kernel launches a batch (copies and sets not counted)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return len(ctx.trace.kernels) / len(ctx.batches)
