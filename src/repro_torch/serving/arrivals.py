"""Arrival-time traces for the serving broker — counterpart of
``repro.serving.arrivals``: the same numpy ``default_rng`` draws, so every
trace equals the reference's bit for bit.

The broker is driven by an explicit trace of request arrival times (seconds,
ascending) instead of a live socket: the same ragged-arrival dynamics —
queueing, coalescing, overload — with full determinism (every trace is a
pure function of its seed), which is what lets the SLO/chaos tests assert
exact broker behavior and the benchmark report reproducible latency
distributions.

Two canonical shapes:

  * ``poisson_trace`` — memoryless arrivals at a constant rate; the
    steady-traffic baseline.
  * ``bursty_trace`` — a square-wave modulated Poisson process (ON windows
    at ``burst_hz``, OFF windows at ``base_hz``): the overload drill. Bursts
    above the engine's service rate are exactly what the degradation ladder
    and admission control exist for.
"""

from __future__ import annotations

import numpy as np


def poisson_trace(rate_hz: float, n: int, seed: int = 0, t0: float = 0.0) -> np.ndarray:
    """(n,) ascending arrival times of a Poisson process at ``rate_hz``."""
    if rate_hz <= 0:
        raise ValueError(f"poisson_trace rate_hz must be positive, got {rate_hz}")
    rng = np.random.default_rng(seed)
    return t0 + np.cumsum(rng.exponential(1.0 / rate_hz, size=n))


def bursty_trace(
    base_hz: float,
    burst_hz: float,
    n: int,
    seed: int = 0,
    period_s: float = 1.0,
    duty: float = 0.25,
    t0: float = 0.0,
) -> np.ndarray:
    """(n,) arrival times of a square-wave modulated Poisson process.

    Each ``period_s`` window opens with a burst phase (``duty`` fraction of
    the period at ``burst_hz``) and relaxes to ``base_hz`` for the rest —
    the classic flash-crowd shape. Sampled by thinning a ``burst_hz``
    homogeneous process, so the inter-arrival structure inside a burst is
    exactly Poisson.
    """
    if not (0.0 < duty <= 1.0):
        raise ValueError(f"bursty_trace duty must be in (0, 1], got {duty}")
    if burst_hz < base_hz or base_hz <= 0:
        raise ValueError(
            f"bursty_trace needs burst_hz >= base_hz > 0, got "
            f"base_hz={base_hz}, burst_hz={burst_hz}"
        )
    rng = np.random.default_rng(seed)
    out = np.empty(n)
    t = t0
    i = 0
    while i < n:
        t += rng.exponential(1.0 / burst_hz)
        phase = (t % period_s) / period_s
        # thinning: outside the burst window keep with prob base/burst
        if phase < duty or rng.random() < base_hz / burst_hz:
            out[i] = t
            i += 1
    return out


def make_trace(kind: str, rate_hz: float, n: int, seed: int = 0, **kw) -> np.ndarray:
    """CLI/bench dispatcher: ``kind`` is "poisson" or "bursty" (bursty
    bursts at 4x the stated rate with the default duty cycle)."""
    if kind == "poisson":
        return poisson_trace(rate_hz, n, seed=seed, **kw)
    if kind == "bursty":
        return bursty_trace(rate_hz, 4.0 * rate_hz, n, seed=seed, **kw)
    raise ValueError(f"unknown arrival trace kind {kind!r} (poisson | bursty)")
