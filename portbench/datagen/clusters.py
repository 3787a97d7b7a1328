"""Near-duplicate clusters: the rows, queries and weights of a cell.

``n / cluster_size`` centres uniform in [centre_lo, centre_hi]^d, each
copied ``cluster_size`` times with Gaussian jitter of standard deviation
``jitter``; a query is a centre picked without replacement plus the same
jitter; a query's weights are ``weight_base + weight_scale·|N(0, 1)|``.
Everything is drawn on ``device`` from the seeds given, in a few large
calls, so a seed gives the same inputs on one kind of device.
"""

from __future__ import annotations

import torch


class Clusters:
    """The rows (n, d) float32 and the query sampler of one seed."""

    def __init__(self, params: dict, n: int, d: int, seed: int, device):
        self.p = params
        self.d = d
        size = int(params["cluster_size"])
        if n % size:
            raise ValueError(f"n={n} is not a whole number of clusters of {size}")
        lo, hi = float(params["centre_lo"]), float(params["centre_hi"])
        gen = torch.Generator(device=device).manual_seed(seed)
        self.centres = torch.rand((n // size, d), generator=gen, device=device) * (hi - lo) + lo
        rows = torch.randn((n // size, size, d), generator=gen, device=device)
        rows.mul_(float(params["jitter"])).add_(self.centres[:, None, :])
        self.rows = rows.reshape(n, d)

    def batch(self, b: int, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
        """b queries on distinct centres and their weights, from ``seed``."""
        dev = self.centres.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        pick = torch.randperm(self.centres.shape[0], generator=gen, device=dev)[:b]
        q = self.centres[pick] + float(self.p["jitter"]) * torch.randn(
            (b, self.d), generator=gen, device=dev)
        w = float(self.p["weight_base"]) + float(self.p["weight_scale"]) * torch.randn(
            (b, self.d), generator=gen, device=dev).abs()
        return q.contiguous(), w.contiguous()


def make(params: dict, n: int, d: int, seed: int, device) -> Clusters:
    return Clusters(params, n, d, seed, device)
