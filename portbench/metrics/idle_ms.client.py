"""Idle device milliseconds a batch whose gaps' midpoints fall in no span of
the program (the client's own code)."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "client")
