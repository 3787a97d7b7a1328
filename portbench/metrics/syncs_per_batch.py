"""Blocking CUDA runtime calls (stream, device and event synchronizes, the
blocking ``cudaMemcpy``) a batch that start inside ``repro_torch.query``."""

from portbench.spans import syncs_per_batch


def read(ctx):
    return syncs_per_batch(ctx)
