"""Idle device milliseconds a batch whose gaps' midpoints fall in
``repro_torch.query`` or ``repro_torch.validate`` and in no stage span."""

from portbench.spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "facade")
