"""Share of ``gather_rerank_topk``'s roofline: its counted work's least time over its
device time in the trace, in %."""

from portbench.readers import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "gather_rerank_topk")
