"""Milliseconds a batch of the stage ``scan``, the exact scan,
``wl1_scan_topk``: from the stream reaching the stage to its last operation
done, timed by the program's own stage span."""

from portbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "scan")
