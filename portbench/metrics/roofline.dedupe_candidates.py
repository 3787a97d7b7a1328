"""Share of ``dedupe_candidates``'s roofline: its counted work's least time over its
device time in the trace, in %."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "dedupe_candidates")
