"""Paper §3–§4.1: discretization, unary coding and the asymmetric transforms.

Counterpart of ``repro.core.transforms``:

  real space [lo, hi]^d --u_t--> lattice {0..M}^d --unary v(.)--> {0,1}^{Md}

  P(o)   = ( 1 - v(o) ; v(o) )                 in {0,1}^{2Md}      (Eq 19)
  Q_w(q) = ( I(w) * (1 - v(q)) ; I(w) * v(q) ) in R^{2Md}          (Eq 20)
  d_w^l1(o, q) = M * sum_i(w_i) - <P(o), Q_w(q)>                   (Eq 21)

``discretize`` is single IEEE operations (subtract, multiply, floor,
clamp), so the lattice levels are bit-equal to the reference's. The
explicit P/Q vectors are O(Md) and exist for the tests and the naive
baseline; hashing never builds them (the §4.2.3 trick in
``hash_families``).
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


def discretization_slack(w: torch.Tensor, space: BoundedSpace) -> torch.Tensor:
    """Observation 1 threshold slack: |R' - R/t| <= sum_i |w_i| / t."""
    return torch.sum(torch.abs(w), dim=-1) / space.t


def unary_code(levels: torch.Tensor, M: int) -> torch.Tensor:
    """Step 1: v(x), (..., d) int -> (..., d, M) f32 in {0, 1}: x_i ones,
    then M - x_i zeros."""
    iota = torch.arange(M, dtype=levels.dtype, device=levels.device)
    return (iota < levels[..., :, None]).to(torch.float32)


def transform_P(levels: torch.Tensor, M: int) -> torch.Tensor:
    """Eq 19: P(o) = (1 - v(o) ; v(o)), (..., d) -> (..., 2Md)."""
    flat = unary_code(levels, M).flatten(-2)
    return torch.cat([1.0 - flat, flat], dim=-1)


def transform_Q(levels: torch.Tensor, w: torch.Tensor, M: int) -> torch.Tensor:
    """Eq 20: Q_w(q) = (I(w) ⊙ (1 - v(q)) ; I(w) ⊙ v(q)), I(w) repeating
    each w_i M times."""
    v = unary_code(levels, M)
    wv = (w[..., :, None] * v).flatten(-2)
    wc = (w[..., :, None] * (1.0 - v)).flatten(-2)
    return torch.cat([wc, wv], dim=-1)


def wl1_via_mips(levels_o: torch.Tensor, levels_q: torch.Tensor, w: torch.Tensor,
                 M: int) -> torch.Tensor:
    """Eq 21 evaluated literally: M * sum(w) - <P(o), Q_w(q)>. Test oracle."""
    P = transform_P(levels_o, M)
    Q = transform_Q(levels_q, w, M)
    return M * torch.sum(w, dim=-1) - torch.sum(P * Q, dim=-1)
