"""The allocator's peak over the window (reset when set-up ends), in GiB."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 2**30
