"""Milliseconds a batch of the stage ``probe``, the window probe (and the
delta key match): from the stream reaching the stage to its last operation
done, timed by the program's own stage span."""

from portbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, "probe")
