"""Host time of ``Index.build``, synchronised on both sides, in set-up."""


def read(ctx):
    return ctx.build_ms
