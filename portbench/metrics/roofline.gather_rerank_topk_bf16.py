"""Share of ``gather_rerank_topk``'s roofline over bfloat16 rows: its counted
work at 2 bytes a row value over its device time in the trace, in %. Read
only in a configuration that stores its rows as bfloat16."""

from portbench.readers import kernel_roofline


def read(ctx):
    if ctx.config["index"]["storage"] != "bf16":
        return None
    return kernel_roofline(ctx, "gather_rerank_topk_bf16")
