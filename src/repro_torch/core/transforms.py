"""Paper Observation 1: the bounded space and its discretization.

Counterpart of ``repro.core.transforms`` (``BoundedSpace``, ``discretize``).
Both are single IEEE operations (subtract, multiply, floor, clamp), so the
lattice levels are bit-equal to the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class BoundedSpace(NamedTuple):
    """The bounded box [lo, hi]^d the data/queries live in (paper §3)."""

    lo: float
    hi: float
    t: float  # discretization resolution; M = floor((hi - lo) * t)

    @property
    def M(self) -> int:
        return int((self.hi - self.lo) * self.t)  # floor for positive operands


def discretize(x: torch.Tensor, space: BoundedSpace) -> torch.Tensor:
    """u_t(x) = floor((x - lo) * t), clipped to {0..M}; (..., d) -> int32.

    The clip guards against floating-point round-up at the upper boundary
    (e.g. hi * t = M + ulp); interior points are untouched.
    """
    levels = torch.floor((x - space.lo) * space.t).to(torch.int32)
    return torch.clamp(levels, 0, space.M)
