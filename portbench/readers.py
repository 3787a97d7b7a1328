"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

A reader takes the run's context and returns a number, or None when the
run holds nothing for it to read (no trace, no such kernel on the path).
"""

from __future__ import annotations

import re

from portbench import peaks


def is_hand_kernel(name: str, symbols) -> bool:
    """Whether a device kernel's name holds one of the program's own kernel
    symbols as a whole identifier."""
    return any(re.search(r"\b%s\b" % re.escape(s), name) for s in symbols)


def work_seconds(ctx, kernels) -> float:
    """The least seconds of the named kernels' counted work over the traced
    window's batches."""
    total = 0.0
    for batch in ctx.batches:
        for kernel in kernels:
            count = ctx.counts[kernel]
            for shape in count.batch_shapes(batch):
                total += peaks.least_time(*count.work(**shape))
    return total


def kernel_roofline(ctx, kernel: str) -> float | None:
    """Least time of the kernel's work over its device time, in %."""
    if ctx.trace is None:
        return None
    spent = ctx.trace.kernel_seconds(ctx.counts[kernel].SYMBOLS)
    least = work_seconds(ctx, [kernel])
    if spent <= 0 or least <= 0:
        return None
    return 100.0 * least / spent
