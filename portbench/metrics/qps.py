"""Queries answered in the window over the window's whole host time."""


def read(ctx):
    return ctx.queries / ctx.window_s
