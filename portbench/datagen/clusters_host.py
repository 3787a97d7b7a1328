"""Near-duplicate clusters whose rows are handed over from host memory.

The rows, queries and weights of ``clusters`` for the same seed and
parameters, drawn by its own code on ``device``; the (n, d) float32 rows
are then copied to the host and the device's copy is freed. The centres,
which the query sampler draws from, stay on ``device``.

Why: a deployment that stores its rows encoded (bfloat16, int8) keeps the
float32 source on the host. ``Index.build`` moves the rows to the card,
hashes them, encodes them and drops the float32 copy, so the card holds
only the encoded table. Rows kept on the card beside the index would add a
float32 copy that no such deployment holds.
"""

from __future__ import annotations

import torch

from portbench import bench

clusters = bench.load_module(bench.PORTBENCH / "datagen" / "clusters.py")


class HostClusters(clusters.Clusters):
    """The rows (n, d) float32 in host memory and the query sampler of one
    seed, which draws on ``device``."""

    def __init__(self, params: dict, n: int, d: int, seed: int, device):
        super().__init__(params, n, d, seed, device)
        self.rows = self.rows.cpu()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def make(params: dict, n: int, d: int, seed: int, device) -> HostClusters:
    return HostClusters(params, n, d, seed, device)
