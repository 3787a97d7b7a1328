"""Device time a batch of the kernels that are not the program's own
(PyTorch's operators on the engine's path), in ms."""

from portbench.readers import is_hand_kernel


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    ns = sum(e - s for name, s, e in ctx.trace.kernels
             if not is_hand_kernel(name, ctx.hand_symbols))
    return ns / 1e6 / len(ctx.batches)
