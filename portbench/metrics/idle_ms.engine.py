"""Idle device milliseconds a batch whose gaps' midpoints fall in one of the
engine's stage spans."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "engine")
