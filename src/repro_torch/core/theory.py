"""Paper theory: collision probabilities (Eq 4/6/25/27), rho (Thm 4/5), (K, L)
selection — counterpart of ``repro.core.theory``.

Closed form. The forward curves and their inverses:

  wl1_from_l2_distance / wl1_from_angular_distance   — Eq 24/26 inverted
  invert_p_l2                                        — Eq 4 inverted (bisection)
  solve_K / solve_tables(P1, P2, n, fail_prob)       — Thm 1 (K, L) for a
                                                       requested failure bound
  solve_bucket_width                                 — W minimizing rho for the
                                                       l2 family at (s1, s2)
  operating_radii                                    — (R1, R2) from a sample
                                                       of observed NN distances

Tensors are computed in their own floating dtype; Python numbers become
f32 tensors, which is what the reference computes in (JAX without x64), so
the engine's early-exit stop decisions compare in the same precision. Integer
powers multiply by repeated squaring in the order ``x ** K`` takes in JAX
(``int_pow``). ``repro_torch.api.planner`` drives ``solve_K`` and
``invert_p_l2``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def _f(x) -> torch.Tensor:
    """``x`` as a floating tensor: a floating tensor as it is, anything else f32."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x
    return torch.as_tensor(x, dtype=torch.float32)


def int_pow(x: torch.Tensor, y: int) -> torch.Tensor:
    """``x ** y`` for an int ``y >= 1`` by repeated squaring, multiplying in
    the order of ``lax.integer_pow`` (what ``x ** K`` lowers to in JAX)."""
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return acc


def p_l2(r, W) -> torch.Tensor:
    """Eq 4 — collision probability of the p-stable L2 hash at l2 distance r."""
    r = _f(r)
    c = (W.to(r.dtype) if isinstance(W, torch.Tensor) else W) / r
    sqrt_2pi = torch.sqrt(torch.tensor(2.0 * math.pi, dtype=r.dtype))
    return 1.0 - 2.0 * torch.special.ndtr(-c) - 2.0 / (sqrt_2pi * c) * (
        1.0 - torch.exp(-(c * c) / 2.0)
    )


def p_theta(r) -> torch.Tensor:
    """Eq 6 — collision probability of SimHash at angular distance r."""
    return 1.0 - _f(r) / math.pi


def l2_distance_from_wl1(r, M: int, d: int, w) -> torch.Tensor:
    """Eq 24: ||P(o) - Q_w(q)||_2 as a function of r = d_w^l1(o, q).

    = sqrt( M (d + sum w_i^2) - 2 (M sum w_i - r) ).
    """
    w = _f(w)
    sw = torch.sum(w, dim=-1)
    sw2 = torch.sum(w * w, dim=-1)
    return torch.sqrt(M * (d + sw2) - 2.0 * (M * sw - _f(r)))


def angular_distance_from_wl1(r, M: int, d: int, w) -> torch.Tensor:
    """Eq 26: angle between P(o) and Q_w(q) as a function of r = d_w^l1(o, q)."""
    w = _f(w)
    sw = torch.sum(w, dim=-1)
    sw2 = torch.sum(w * w, dim=-1)
    cosang = (M * sw - _f(r)) / (M * torch.sqrt(d * sw2))
    return torch.arccos(torch.clamp(cosang, -1.0, 1.0))


def collision_prob_l2(r, M: int, d: int, w, W) -> torch.Tensor:
    """Eq 25 — collision probability of (d_w^l1, l2)-ALSH at weighted-L1 distance r."""
    return p_l2(l2_distance_from_wl1(r, M, d, w), W)


def collision_prob_theta(r, M: int, d: int, w) -> torch.Tensor:
    """Eq 27 — collision probability of (d_w^l1, theta)-ALSH at weighted-L1 distance r."""
    return p_theta(angular_distance_from_wl1(r, M, d, w))


def rho(R1, R2, M: int, d: int, w, family: str = "theta", W: float = 4.0) -> torch.Tensor:
    """Thm 4/5: rho = log P(R1) / log P(R2) — the sublinearity exponent (< 1)."""
    if family == "l2":
        p1 = collision_prob_l2(R1, M, d, w, W)
        p2 = collision_prob_l2(R2, M, d, w, W)
    else:
        p1 = collision_prob_theta(R1, M, d, w)
        p2 = collision_prob_theta(R2, M, d, w)
    return torch.log(p1) / torch.log(p2)


class IndexPlan(NamedTuple):
    """Derived index geometry from LSH theory (Theorem 1 construction)."""

    K: int  # concatenated hashes per table: collision prob p^K
    L: int  # number of tables: L ~ n^rho for >= 1 - 1/e success
    rho: float
    P1: float
    P2: float


def plan_index(
    n: int,
    R1: float,
    R2: float,
    M: int,
    d: int,
    w_scale: float = 1.0,
    family: str = "theta",
    W: float = 4.0,
    max_K: int = 32,
    max_L: int = 256,
) -> IndexPlan:
    """Pick (K, L) per Theorem 1 for a worst-case weight magnitude profile
    (the all-``w_scale`` vector). Success probability per query is
    >= 1 - (1 - P1^K)^L (≈ 1 - 1/e at L = ceil(P1^-K)). ``max_K`` is clamped
    to the family's per-table cap (theta packs K codes into an int32 key)."""
    from repro_torch.core.families import get_family  # families ↛ theory

    fam_cap = get_family(family).max_K
    if fam_cap is not None:
        max_K = min(max_K, fam_cap)
    w = torch.full((d,), float(w_scale))
    if family == "l2":
        P1 = float(collision_prob_l2(R1, M, d, w, W))
        P2 = float(collision_prob_l2(R2, M, d, w, W))
    else:
        P1 = float(collision_prob_theta(R1, M, d, w))
        P2 = float(collision_prob_theta(R2, M, d, w))
    if not (0.0 < P2 < P1 < 1.0):
        raise ValueError(f"degenerate collision probs P1={P1} P2={P2}; widen (R1, R2)")
    r = math.log(P1) / math.log(P2)
    K = max(1, min(max_K, math.ceil(math.log(n) / math.log(1.0 / P2))))
    L = max(1, min(max_L, math.ceil(P1 ** (-K))))
    return IndexPlan(K=K, L=L, rho=r, P1=P1, P2=P2)


def success_probability(plan: IndexPlan) -> float:
    """P[some table collides with an R1-near neighbour] = 1 - (1 - P1^K)^L."""
    return 1.0 - (1.0 - plan.P1**plan.K) ** plan.L


# ---------------------------------------------------------------------------
# Inverse solvers — quality targets in, mechanism out (the planner's substrate)
# ---------------------------------------------------------------------------


def wl1_from_l2_distance(s, M: int, d: int, w) -> torch.Tensor:
    """Eq 24 inverted: the d_w^l1 distance r whose transformed l2 distance is s.

    From s^2 = M (d + sum w_i^2) - 2 (M sum w_i - r):
    r = M sum w_i - (M (d + sum w_i^2) - s^2) / 2.
    """
    w = _f(w)
    sw = torch.sum(w, dim=-1)
    sw2 = torch.sum(w * w, dim=-1)
    return M * sw - (M * (d + sw2) - torch.square(_f(s))) / 2.0


def wl1_from_angular_distance(ang, M: int, d: int, w) -> torch.Tensor:
    """Eq 26 inverted: the d_w^l1 distance r whose transformed angle is ang."""
    w = _f(w)
    sw = torch.sum(w, dim=-1)
    sw2 = torch.sum(w * w, dim=-1)
    return M * sw - torch.cos(_f(ang)) * M * torch.sqrt(d * sw2)


def invert_p_l2(p: float, W: float, r_hi: float = 1e9) -> float:
    """Eq 4 inverted: the l2 distance r at which p_l2(r, W) == p.

    ``p_l2`` is strictly decreasing in r with range (0, 1), so the root is
    unique; solved by bisection on r in (0, r_hi], host-side.
    """
    if not (0.0 < p < 1.0):
        raise ValueError(f"invert_p_l2: p must be in (0, 1), got {p}")
    lo, hi = 1e-12, float(r_hi)
    if float(p_l2(hi, W)) > p:  # p unreachably small even at r_hi
        return hi
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if float(p_l2(mid, W)) > p:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-9 * max(1.0, hi):
            break
    return 0.5 * (lo + hi)


def solve_K(P2: float, n: int, max_K: int = 32) -> int:
    """Thm 1 hash count: K = ceil(ln n / ln(1/P2)) caps the expected
    far-point collisions per table at O(1); clamped to [1, max_K]."""
    if not (0.0 < P2 < 1.0):
        raise ValueError(f"solve_K: P2 must be in (0, 1), got {P2}")
    return max(1, min(max_K, math.ceil(math.log(n) / math.log(1.0 / P2))))


def solve_tables(
    P1: float,
    P2: float,
    n: int,
    fail_prob: float = math.exp(-1.0),
    max_K: int = 32,
    max_L: int = 1024,
) -> tuple[int, int]:
    """Thm 1 construction solved for a REQUESTED failure bound: K from
    :func:`solve_K`, L = ceil(ln(delta) / ln(1 - P1^K)) so the miss
    probability (1 - P1^K)^L of an R1-near neighbour is <= delta =
    ``fail_prob``. Returns (K, L) clamped to [1, max_K] x [1, max_L]."""
    if not (0.0 < P2 < P1 < 1.0):
        raise ValueError(f"solve_tables: need 0 < P2 < P1 < 1, got P1={P1} P2={P2}")
    if not (0.0 < fail_prob < 1.0):
        raise ValueError(f"solve_tables: fail_prob must be in (0, 1), got {fail_prob}")
    K = solve_K(P2, n, max_K)
    p_hit = P1**K
    if p_hit >= 1.0:
        L = 1
    else:
        L = math.ceil(math.log(fail_prob) / math.log1p(-p_hit))
    return K, max(1, min(max_L, L))


def _linspace(start: float, stop: float, num: int) -> torch.Tensor:
    """f32 ``jnp.linspace(start, stop, num)`` as JAX computes it:
    ``start·(1 − t) + stop·t`` for t = i/(num−1), the endpoint exact."""
    a = torch.tensor(start, dtype=torch.float32)
    b = torch.tensor(stop, dtype=torch.float32)
    div = num - 1
    t = torch.arange(div, dtype=torch.float32) / torch.tensor(float(div), dtype=torch.float32)
    return torch.cat([a * (1 - t) + b * t, b[None]])


def solve_bucket_width(
    s1: float,
    s2: float,
    lo_factor: float = 0.05,
    hi_factor: float = 8.0,
    steps: int = 256,
) -> float:
    """Pick the l2 family's bucket width W minimizing rho at the TRANSFORMED
    l2 distances (s1, s2) of the near/far radii (Eq 24), by a log-spaced grid
    search over [lo_factor*s2, hi_factor*s2] (accurate to ~1%)."""
    if not (0.0 < s1 < s2):
        raise ValueError(f"solve_bucket_width: need 0 < s1 < s2, got {s1}, {s2}")
    ws = torch.exp(_linspace(math.log(lo_factor * s2), math.log(hi_factor * s2), steps))
    p1 = p_l2(s1, ws)
    p2 = p_l2(s2, ws)
    # guard the open ends where p -> 0 or 1 and the ratio degenerates
    eps = 1e-12
    rhos = torch.log(torch.clamp(p1, eps, 1 - eps)) / torch.log(torch.clamp(p2, eps, 1 - eps))
    ok = (p1 > eps) & (p2 > eps) & (p1 < 1 - eps) & (p2 < 1 - eps)
    rhos = torch.where(ok, rhos, torch.full_like(rhos, float("inf")))
    return float(ws[int(torch.argmin(rhos))])


def operating_radii(
    nn_dists, approx_c: float, quantile: float = 0.5, r_max: float | None = None
) -> tuple[float, float]:
    """(R1, R2) from a calibration sample of observed NN distances: R1 the
    ``quantile`` of the sample, R2 = approx_c * R1, both clamped to (0,
    r_max) when the geometric diameter ``r_max`` is given (degenerate samples
    fall back to r_max / (2 * approx_c))."""
    if approx_c <= 1.0:
        raise ValueError(f"operating_radii: approx_c must be > 1, got {approx_c}")
    if isinstance(nn_dists, torch.Tensor):
        nn_dists = nn_dists.detach().cpu().numpy()
    arr = np.asarray(nn_dists, dtype=np.float64).reshape(-1)
    arr = arr[np.isfinite(arr)]
    R1 = float(np.quantile(arr, quantile)) if arr.size else 0.0
    if r_max is not None and (R1 <= 0.0 or approx_c * R1 >= r_max):
        R1 = min(R1, r_max / (2.0 * approx_c)) or r_max / (2.0 * approx_c)
    if R1 <= 0.0:
        raise ValueError(
            "operating_radii: calibration sample gave a non-positive near "
            "radius and no r_max fallback was provided"
        )
    return R1, approx_c * R1
