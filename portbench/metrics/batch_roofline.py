"""Least time of each batch's counted work (the kernels the traffic file
lists under ``work``) over the batches' host time, in %."""

from portbench.readers import work_seconds


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    least = work_seconds(ctx, ctx.traffic["work"])
    return 100.0 * least / sum(ctx.walls) if least > 0 else None
