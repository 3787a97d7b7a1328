"""95th percentile of the window's batch times, call to results on the host."""

import statistics


def read(ctx):
    if len(ctx.walls) < 2:
        return None
    return 1e3 * statistics.quantiles(ctx.walls, n=20, method="inclusive")[18]
