"""Process start to the first timed batch."""


def read(ctx):
    return ctx.setup_s
