"""Failure injection and straggler telemetry — the two classes of
``repro.runtime.fault`` that the serving tier needs.

The rest of the reference module is the LM training loop with its
checkpoint/restart logic, which belongs to the LM stack (ROADMAP Queue A
item 14) and is not ported here.
"""

from __future__ import annotations

from dataclasses import dataclass, field


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclass
class StragglerMonitor:
    """EWMA mean/variance over per-step (or per-request) durations.

    Two consumers share it: a training loop's straggler rule (``observe``
    flags k·sigma outliers WITHOUT folding them into the estimate — a
    straggler must not drag the baseline up), and the serving tier's latency
    tracker (``ewma_quantile`` — there ``k_sigma=inf`` so overload latencies
    DO update the estimate; an admission controller that ignored its own
    overload signal would never degrade).
    """

    alpha: float = 0.2
    k_sigma: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= 3:
            sd = max(self.var**0.5, 1e-6)
            if dt > self.mean + self.k_sigma * sd:
                self.flagged.append((step, dt))
                return True
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1
        return False

    def ewma_quantile(self, z: float = 2.326) -> float:
        """Normal-approximation EWMA quantile: ``mean + z·sd`` (z=2.326 is
        the 99th percentile). A smoothed tail estimate, not an exact order
        statistic — what an SLO admission controller wants: responsive to
        sustained shifts, calm about single spikes."""
        return self.mean + z * max(self.var, 0.0) ** 0.5
