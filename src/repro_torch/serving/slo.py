"""SLO tracking and graceful degradation for the serving broker —
counterpart of ``repro.serving.slo``.

Admission control here is *quality-aware*: when the observed p99 breaches
the SLO the broker does not just shed load — it first walks down the
index's calibrated plan ladder (``Index.plan_ladder``), trading predicted
recall for candidate volume one rung at a time. Every degraded response is
stamped with the rung and the planner's calibrated ``predicted_recall`` /
``predicted_success`` for that rung, so a degraded answer is *labeled*,
never silent. Shedding (deadline expiry, queue overflow) is the last
resort, applied per-request before the batch is formed.

The latency estimate is the ``StragglerMonitor`` EWMA from
``runtime/fault.py`` with ``k_sigma=inf``: unlike a training straggler rule
(which must NOT fold outliers into its baseline), an admission controller
must fold its own overload signal into the estimate or it would never
react.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.runtime.fault import StragglerMonitor


@dataclass(frozen=True)
class SLOConfig:
    """Service-level objective and controller tuning.

    ``p99_ms`` is the target tail latency. ``deadline_ms`` (default 4x the
    SLO) is the per-request hard deadline: a request still queued past it is
    shed rather than served uselessly late. The controller degrades one rung
    per breached batch and recovers one rung after ``patience`` consecutive
    healthy batches (p99 under ``recover_factor``·SLO *and* an empty queue) —
    the asymmetry damps flapping at the SLO boundary.
    """

    p99_ms: float
    deadline_ms: float | None = None
    recover_factor: float = 0.6
    patience: int = 8
    alpha: float = 0.2
    z_p99: float = 2.326

    @property
    def effective_deadline_ms(self) -> float:
        return self.deadline_ms if self.deadline_ms is not None else 4.0 * self.p99_ms


class LatencyTracker:
    """EWMA p99 estimate over observed per-request latencies (ms)."""

    def __init__(self, slo: SLOConfig):
        self._slo = slo
        self._mon = StragglerMonitor(alpha=slo.alpha, k_sigma=math.inf)

    def observe(self, latency_ms: float) -> None:
        self._mon.observe(self._mon.n, latency_ms)

    @property
    def p99_ms(self) -> float:
        return self._mon.ewma_quantile(self._slo.z_p99)

    @property
    def n(self) -> int:
        return self._mon.n


class DegradationController:
    """Walks the calibrated plan ladder in response to SLO breaches.

    Rung 0 is the plan the Planner would have chosen for the recall target;
    rungs 1..R-1 are strictly cheaper, cost-descending. ``on_batch`` is
    called once per served batch with the tracker's current p99 and whether
    the queue drained; it moves at most one rung per call.
    """

    def __init__(self, slo: SLOConfig, n_rungs: int):
        if n_rungs < 1:
            raise ValueError(f"need at least one ladder rung, got {n_rungs}")
        self.slo = slo
        self.n_rungs = n_rungs
        self.rung = 0
        self.degrades = 0
        self.recoveries = 0
        self._healthy_streak = 0

    def on_batch(self, p99_ms: float, queue_empty: bool) -> int:
        """Update the active rung from the latest p99 estimate; returns it."""
        if p99_ms > self.slo.p99_ms:
            self._healthy_streak = 0
            if self.rung < self.n_rungs - 1:
                self.rung += 1
                self.degrades += 1
        elif p99_ms < self.slo.recover_factor * self.slo.p99_ms and queue_empty:
            self._healthy_streak += 1
            if self._healthy_streak >= self.slo.patience and self.rung > 0:
                self.rung -= 1
                self.recoveries += 1
                self._healthy_streak = 0
        else:
            self._healthy_streak = 0
        return self.rung
