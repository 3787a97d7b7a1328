"""The serving broker: dynamic batching, SLO admission control, chaos —
counterpart of ``repro.serving.broker``.

One object in front of the engine that turns ragged request arrivals into
fixed-shape batched queries, while keeping the tail latency inside an SLO
by *labeled* degradation instead of unbounded queueing:

  * **Dynamic batching** — arrivals queue; each service round drains up to
    ``max_batch`` requests and pads them to the next power-of-two bucket,
    so every (bucket, rung) combination runs once at warmup. The port has
    no jit cache; ``assert_no_retrace`` checks that no kernel library was
    built or loaded after warmup (``analysis.retrace_guard``) — a build in
    steady state is a serving bug, not a slowdown to shrug at.
  * **Admission control** — a bounded queue (overflow ⇒ shed on arrival)
    and a per-request deadline (expired ⇒ shed at dequeue, not served
    uselessly late).
  * **Graceful degradation** — when the EWMA p99 breaches the SLO the
    controller steps down the index's calibrated plan ladder; every
    response is stamped with the rung served and that rung's calibrated
    ``predicted_recall``/``predicted_success``. Degraded answers are
    labeled, never silent.
  * **Chaos** — an optional :class:`~repro_torch.serving.chaos.ShardSet` target
    with a scripted mid-stream shard kill: survivors keep answering (the
    response's ``coverage`` says how much of the database was consulted)
    while the broker's clock drives backoff-limited shard recovery.

Time model: a discrete-event loop over an explicit arrival trace (see
``arrivals``). The clock is *virtual* — it advances by each round's
service time, which is measured wall-clock by default (benchmarks, live
serving) or supplied by an injectable ``service_time_fn`` (deterministic
SLO tests, modeled overload). Queueing delay, deadlines, shedding, and
degradation dynamics are identical either way. The measured time ends when
the answer is in host memory: on the card that copy is the wait for the
device, so the service time is the device's, not only the host's launches.

Answers keep the reference's dtypes: int32 ids and float32 dists from a
single index, int64/float64 from the shard set's host merge.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from time import perf_counter
from typing import Callable, Optional

import numpy as np

from repro_torch.analysis.retrace_guard import RetraceGuard
from repro_torch.api.index import Index
from repro_torch.api.spec import PlannedSpec, QualitySpec
from repro_torch.serving.chaos import ShardSet
from repro_torch.serving.slo import DegradationController, LatencyTracker, SLOConfig


@dataclass(frozen=True)
class Request:
    """One query in flight: a single (q, w) row plus its arrival time."""

    rid: int
    arrival_s: float
    query: np.ndarray  # (d,)
    weight: np.ndarray  # (d,)


@dataclass(frozen=True)
class Response:
    rid: int
    status: str  # "ok" | "degraded" | "shed"
    ids: Optional[np.ndarray]  # (k,) global ids; None when shed
    dists: Optional[np.ndarray]  # (k,) distances; None when shed
    rung: int  # ladder rung served (0 = full quality)
    spec: Optional[PlannedSpec]  # the plan actually executed
    predicted_recall: float  # calibrated recall of that rung
    predicted_success: float  # Thm 1 success bound of that rung
    coverage: float  # fraction of shards consulted (1.0 single-host)
    latency_ms: float  # arrival -> answer in broker virtual time
    shed_reason: Optional[str] = None  # "queue_full" | "deadline"


@dataclass(frozen=True)
class BrokerConfig:
    max_batch: int = 64
    max_queue: int = 256
    warmup: bool = True


@dataclass
class BrokerStats:
    served: int = 0
    shed: int = 0
    degraded: int = 0
    p50_ms: float = 0.0
    p99_ms: float = 0.0
    throughput_rps: float = 0.0
    shed_rate: float = 0.0
    degraded_frac: float = 0.0
    mean_coverage: float = 1.0
    rung_counts: dict = field(default_factory=dict)
    degrades: int = 0
    recoveries: int = 0


def _bucket_ladder(max_batch: int) -> list:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


class Broker:
    """Discrete-event serving broker over an Index or ShardSet target.

    The quality contract (``QualitySpec``) is resolved ONCE into the
    degradation ladder via ``index.plan_ladder`` — rung 0 is the planner's
    contract-meeting choice, later rungs strictly cheaper. The broker never
    invents query parameters; it only moves along calibrated rungs.
    """

    def __init__(
        self,
        index: Index,
        quality: QualitySpec,
        slo: SLOConfig,
        config: BrokerConfig = BrokerConfig(),
        shardset: Optional[ShardSet] = None,
        service_time_fn: Optional[Callable[[int, int, PlannedSpec], float]] = None,
    ):
        self.index = index
        self.quality = quality
        self.slo = slo
        self.config = config
        self.shardset = shardset
        self.service_time_fn = service_time_fn
        self.ladder = index.plan_ladder(quality)
        self.buckets = _bucket_ladder(config.max_batch)
        self.tracker = LatencyTracker(slo)
        self.controller = DegradationController(slo, len(self.ladder))
        self._retrace_guard = RetraceGuard()  # watches the kernel-library count
        if config.warmup:
            self.warmup()

    # -- warmup contract -----------------------------------------------------
    def bucket_for(self, m: int) -> int:
        for b in self.buckets:
            if m <= b:
                return b
        return self.buckets[-1]

    def _targets(self):
        if self.shardset is not None:
            return [s for s in self.shardset.shards if s is not None]
        return [self.index]

    def warmup(self) -> None:
        """Run every (bucket, rung, target) combination up front — which
        builds or loads every kernel those queries launch — then snapshot
        the kernel-library count: steady-state serving must never build."""
        d = self.index.d
        for b in self.buckets:
            q = np.zeros((b, d), np.float32)
            w = np.ones((b, d), np.float32)
            for spec in self.ladder:
                for t in self._targets():
                    t.query(q, w, spec)
        self._retrace_guard.snapshot()

    def assert_no_retrace(self) -> None:
        """Raise if a kernel library was built or loaded since warmup (a
        bucket, rung or kernel the warmup did not cover). Delegates to
        :class:`repro_torch.analysis.retrace_guard.RetraceGuard` — the
        error is a ``RetraceError`` (an ``AssertionError`` subclass)."""
        if not self._retrace_guard.snapshotted:
            raise RuntimeError("assert_no_retrace needs warmup() first")
        self._retrace_guard.assert_no_retrace(
            context="serving (a bucket or rung not covered by warmup)"
        )

    # -- the service loop ----------------------------------------------------
    def _execute(self, q: np.ndarray, w: np.ndarray, spec: PlannedSpec, now_s: float):
        """(dists, ids, coverage, measured_dt_s) for one padded bucket. The
        copy of the answer to host memory is inside the timed window: on
        the card it is the wait for the device."""
        t0 = perf_counter()
        if self.shardset is not None:
            res = self.shardset.query(q, w, spec, now_s=now_s)
            dists, ids, cov = res.dists, res.ids, res.coverage
        else:
            res = self.index.query(q, w, spec)
            dists = res.dists.cpu().numpy()
            ids = res.ids.cpu().numpy()
            cov = 1.0
        return dists, ids, cov, perf_counter() - t0

    def run(self, requests: list) -> tuple[list, BrokerStats]:
        """Serve an arrival-ordered request list to completion.

        Returns (responses in completion order, aggregate stats). Every
        request gets exactly one Response — served (ok/degraded) or shed
        with a reason.
        """
        d = self.index.d
        deadline_s = self.slo.effective_deadline_ms / 1e3
        queue: deque = deque()
        responses: list = []
        clock = 0.0
        i, n = 0, len(requests)

        def shed(req: Request, reason: str, t: float) -> None:
            responses.append(
                Response(
                    rid=req.rid,
                    status="shed",
                    ids=None,
                    dists=None,
                    rung=self.controller.rung,
                    spec=None,
                    predicted_recall=0.0,
                    predicted_success=0.0,
                    coverage=0.0,
                    latency_ms=(t - req.arrival_s) * 1e3,
                    shed_reason=reason,
                )
            )

        while i < n or queue:
            if not queue and requests[i].arrival_s > clock:
                clock = requests[i].arrival_s  # idle: jump to next arrival
            while i < n and requests[i].arrival_s <= clock:
                if len(queue) >= self.config.max_queue:
                    shed(requests[i], "queue_full", requests[i].arrival_s)
                else:
                    queue.append(requests[i])
                i += 1
            if self.shardset is not None:
                self.shardset.tick(clock)
            batch: list = []
            while queue and len(batch) < self.config.max_batch:
                req = queue.popleft()
                if clock - req.arrival_s > deadline_s:
                    shed(req, "deadline", clock)
                else:
                    batch.append(req)
            if not batch:
                continue

            rung = self.controller.rung
            spec = self.ladder[rung]
            bucket = self.bucket_for(len(batch))
            q = np.zeros((bucket, d), np.float32)
            w = np.ones((bucket, d), np.float32)
            for j, req in enumerate(batch):
                q[j] = req.query
                w[j] = req.weight
            dists, ids, cov, measured_dt = self._execute(q, w, spec, clock)
            dt = (
                self.service_time_fn(bucket, rung, spec)
                if self.service_time_fn is not None
                else measured_dt
            )
            clock += dt

            degraded = rung > 0 or cov < 1.0
            for j, req in enumerate(batch):
                lat_ms = (clock - req.arrival_s) * 1e3
                self.tracker.observe(lat_ms)
                responses.append(
                    Response(
                        rid=req.rid,
                        status="degraded" if degraded else "ok",
                        ids=ids[j].copy(),
                        dists=dists[j].copy(),
                        rung=rung,
                        spec=spec,
                        predicted_recall=float(spec.predicted_recall),
                        predicted_success=float(spec.predicted_success),
                        coverage=cov,
                        latency_ms=lat_ms,
                    )
                )
            self.controller.on_batch(self.tracker.p99_ms, not queue)

        return responses, self._stats(responses, requests)

    def _stats(self, responses: list, requests: list) -> BrokerStats:
        served = [r for r in responses if r.status != "shed"]
        shed = [r for r in responses if r.status == "shed"]
        stats = BrokerStats(served=len(served), shed=len(shed))
        stats.degrades = self.controller.degrades
        stats.recoveries = self.controller.recoveries
        if responses:
            stats.shed_rate = len(shed) / len(responses)
        if served:
            lats = np.array([r.latency_ms for r in served])
            stats.p50_ms = float(np.percentile(lats, 50))
            stats.p99_ms = float(np.percentile(lats, 99))
            stats.degraded = sum(1 for r in served if r.status == "degraded")
            stats.degraded_frac = stats.degraded / len(served)
            stats.mean_coverage = float(
                np.mean([r.coverage for r in served])
            )
            for r in served:
                stats.rung_counts[r.rung] = stats.rung_counts.get(r.rung, 0) + 1
            t0 = min(r.arrival_s for r in requests)
            t1 = max(r.arrival_s for r in requests) + max(lats) / 1e3
            if t1 > t0:
                stats.throughput_rps = len(served) / (t1 - t0)
        return stats


def requests_from_trace(
    arrivals: np.ndarray, queries: np.ndarray, weights: np.ndarray
) -> list:
    """Zip an arrival trace with query/weight rows (cycled if shorter)
    into an arrival-ordered Request list."""
    nq = queries.shape[0]
    return [
        Request(
            rid=r,
            arrival_s=float(t),
            query=np.asarray(queries[r % nq], np.float32),
            weight=np.asarray(weights[r % nq], np.float32),
        )
        for r, t in enumerate(arrivals)
    ]
