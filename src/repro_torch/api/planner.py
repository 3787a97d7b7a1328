"""The query planner — quality targets in, mechanism out. Counterpart of
``repro.api.planner``.

**Build time** (:meth:`Planner.plan_config`): theory inversion on a data
sample. Discretize the data, measure each sampled query's kth-NN distance in
lattice units with the exact scan (``ops.wl1_scan_topk`` on f32 levels — the
hand kernel on the card), evaluate Eq 25/27 at the per-query radii ``r1_i``
and ``r2_i = c·r1_i`` (the l2 family's bucket width ``W`` anchored at a
fixed collision probability on the 75th-percentile transformed near
distance), then solve Theorem 1: ``K = ceil(ln n / ln 1/P2)`` and the
smallest ``L`` whose per-sample mean success ``mean_i[1-(1-p1_i^K)^L]``
reaches ``max(recall_target, 1-fail_prob)``, with a hash budget that walks K
down when K·L overshoots. ``family="auto"`` solves both families and keeps
the lower rho.

**Query time** (:meth:`Planner.plan_query`): an empirical calibration pass
against the built index. A deterministic sample of jittered data rows is
queried once in exact mode, every rung of a short ladder of execution plans
(single probe at shrinking windows, multiprobe at growing probe counts,
their early-exit twins, and on quantized storage their screened twins) runs
through ``Index.query``, and the cheapest rung whose measured recall@k meets
``recall_target`` wins. Calibration runs the very queries the plan will
run, so ``query(q, w, quality) == query(q, w, plan)`` bit for bit.

**Empirical prior** (``Planner(table=...)``): an offline
:class:`repro_torch.tuner.TuningTable`. When the index's profile (family, n,
d, weight skew) lands in a scanned bucket, ``plan_config`` takes the
cheapest frontier geometry meeting the target and ``plan_query`` runs one
confirmation query of the frontier's plan instead of the ladder (stamped
``provenance="prior"``); anything else falls back to the calibrated path,
equal to a table-less planner's.

**Sampling.** The reference draws its samples with ``jax.random``, which
torch cannot replay. Here every sample is drawn from a CPU
``torch.Generator`` seeded from (the index's ``build_key`` words — the
marker ``persist.PORT_BUILT_KEY`` for an index this package built — the
``QualitySpec.seed``), then moved to the index's device, so one index plans
the same on either device. Planning is deterministic given (index, seed).

**Precision.** Each step runs in the reference's dtype: the theory curves,
the quantile of ``s1`` and the medians in f32 (``jnp.quantile``'s linear and
``jnp.median``'s midpoint rule, which for an even count averages the two
middle values where ``torch.median`` returns the lower); the clipped ``p1``,
its quartile and the ``L`` bisection in f64; means of counts in f32.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import warnings

import numpy as np
import torch

from repro_torch.api.persist import PORT_BUILT_KEY
from repro_torch.api.spec import PlannedSpec, QualitySpec, QuerySpec
from repro_torch.core import theory, transforms
from repro_torch.core.families import get_family, n_flip_subsets
from repro_torch.core.index import IndexConfig
from repro_torch.core.transforms import BoundedSpace

__all__ = ["Planner", "QueryReport", "default_calibration_weights", "planning_generator",
           "seeded_generator"]

# plan_config samples before any index exists: the reference folds the seed
# into an all-zero key there
_ZERO_KEY = np.zeros((2,), np.uint32)


def default_calibration_weights(generator: torch.Generator, shape) -> torch.Tensor:
    """The planner's reference weight distribution: |N(0, 1)| + 0.1 per dim
    (the weight profile the repo's benchmarks and examples query with)."""
    return torch.randn(tuple(shape), generator=generator).abs() + 0.1


def seeded_generator(*ints: int) -> torch.Generator:
    """A CPU generator seeded from a hash of ``ints`` (any number of ints,
    negative ones too)."""
    digest = hashlib.sha256(",".join(str(int(x)) for x in ints).encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little"))


def planning_generator(build_key, seed: int, *fold: int) -> torch.Generator:
    """The planning sample's generator: seeded from the key's two uint32
    words, ``seed`` and the ``fold`` salts (None as key: ``PORT_BUILT_KEY``)."""
    words = np.asarray(PORT_BUILT_KEY if build_key is None else build_key,
                       np.uint32).reshape(-1)[:2]
    return seeded_generator(*words, seed, *fold)


def _sorted_f32(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x.detach().to("cpu", torch.float32).flatten()).values


def quantile_f32(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear method) as XLA computes it on the CPU:
    the bracketing order statistics ``lo``, ``hi`` weighted ``1 - h`` and
    ``h`` (``h = q(n-1) - floor(q(n-1))``, f32), summed as the fused
    multiply-add ``fma(hi, h, f32(lo·(1-h)))`` — emulated in f64 and rounded
    to f32. NaN if any element is NaN."""
    a = _sorted_f32(x)
    if bool(torch.isnan(a).any()):
        return torch.tensor(float("nan"))
    pos = torch.tensor(q, dtype=torch.float32) * (a.numel() - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lo_term = a[int(low)] * (1 - hw)
    return (a[int(high)].double() * hw.double() + lo_term.double()).to(torch.float32)


def median_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x)`` in f32: the midpoint of the two middle order
    statistics (``torch.median`` returns the lower one for an even count)."""
    a = _sorted_f32(x)
    if bool(torch.isnan(a).any()):
        return torch.tensor(float("nan"))
    n = a.numel()
    return (a[(n - 1) // 2] + a[n // 2]) * 0.5


def mean_f32(x: torch.Tensor) -> float:
    """``float(jnp.mean(x))`` of an int32 count vector: an f32 sum over an
    f32 count (exact while the sum stays under 2**24)."""
    return float(x.to(torch.float32).sum() / x.numel())


def _n_windows(cfg, plan) -> int:
    """Size of the (table, probe-rank) window lattice ``plan`` visits — the
    ``expected_tables`` of a plan that never exits early."""
    return cfg.L * (plan.n_probes if plan.mode == "multiprobe" else 1)


@dataclasses.dataclass
class QueryReport:
    """Per-query diagnostics from ``Index.explain``: the spec that ran, the
    theory prediction, and what actually happened.

    Attributes:
      spec: the spec that EXECUTED (a QuerySpec, or the PlannedSpec a
        QualitySpec resolved to).
      quality: the QualitySpec the caller stated (None for mechanism specs).
      result: the :class:`~repro_torch.core.index.QueryResult` (the arrays
        ``Index.query`` returns — explain never changes the answer).
      predicted_success: (b,) Thm 1 success bound 1-(1-p1^K)^L per query,
        p1 = Eq 25/27 at the query's OWN weights and observed top-1
        distance (0.0 where the query returned nothing); for multiprobe the
        single-probe lower bound.
      n_candidates: (b,) unique candidates examined (the sublinearity metric).
      truncated_tables: (b,) probed buckets whose window exceeded the
        effective ``max_candidates`` (candidates dropped before the re-rank).
      n_invalid: (b,) sentinel result slots (ids == -1).
      provenance: how a planned spec was resolved — "calibrated" | "prior"
        (None for mechanism specs).
      plan_build_s: wall seconds the plan resolution cost in THIS process
        (None for mechanism specs and for plans loaded from a manifest).
      storage: the index's row codec ("f32" | "bf16" | "int8").
      rows_screened: (b,) candidates ranked by the quantized proxy screen
        (0 everywhere when the screen was off).
      rows_reranked: (b,) candidates the exact rerank decoded.
      bytes_gathered: (b,) table payload bytes the fused tail gathered
        (screen + rerank passes, at the encoded row width).
      table_bytes: resident bytes of the row tables (main + delta payload +
        scales).
      tables_probed: (b,) probe windows the streamed early-exit tail visited
        (None when the monolithic tail ran).
      stop_reason: (b,) int32 early-exit stop code — 0 exhausted, 1
        geometric, 2 confidence (None with the monolithic tail).
    """

    spec: object
    quality: QualitySpec | None
    result: object
    predicted_success: np.ndarray
    n_candidates: np.ndarray
    truncated_tables: np.ndarray
    n_invalid: np.ndarray
    provenance: str | None = None
    plan_build_s: float | None = None
    storage: str | None = None
    rows_screened: np.ndarray | None = None
    rows_reranked: np.ndarray | None = None
    bytes_gathered: np.ndarray | None = None
    table_bytes: int | None = None
    tables_probed: np.ndarray | None = None
    stop_reason: np.ndarray | None = None

    def to_dict(self) -> dict:
        """JSON-able summary (arrays reduced to batch means) for logging."""

        def mean(a):
            return float(np.mean(a)) if a is not None else None

        return {
            "spec": (dataclasses.asdict(self.spec) if dataclasses.is_dataclass(self.spec)
                     else str(self.spec)),
            "quality": dataclasses.asdict(self.quality) if self.quality else None,
            "provenance": self.provenance,
            "plan_build_s": self.plan_build_s,
            "mean_predicted_success": mean(self.predicted_success),
            "mean_n_candidates": mean(self.n_candidates),
            "queries_with_truncation": int(np.sum(self.truncated_tables > 0)),
            "queries_with_invalid_slots": int(np.sum(self.n_invalid > 0)),
            "storage": self.storage,
            "mean_rows_screened": mean(self.rows_screened),
            "mean_rows_reranked": mean(self.rows_reranked),
            "mean_bytes_gathered": mean(self.bytes_gathered),
            "table_bytes": self.table_bytes,
            "mean_tables_probed": mean(self.tables_probed),
            "stop_reasons": (
                {
                    "exhausted": int(np.sum(self.stop_reason == 0)),
                    "geometric": int(np.sum(self.stop_reason == 1)),
                    "confidence": int(np.sum(self.stop_reason == 2)),
                }
                if self.stop_reason is not None else None
            ),
        }


@dataclasses.dataclass
class Planner:
    """Resolves :class:`QualitySpec` targets to concrete parameters.

    Attributes:
      weights: optional (d,) or (m, d) calibration weight profile; default
        :func:`default_calibration_weights`.
      candidates_per_ms: the linear cost model behind
        ``QualitySpec.latency_budget_ms``: a budget of B ms admits plans
        examining at most ``B * candidates_per_ms`` candidates per query.
        The default is the reference's (a conservative CPU figure), kept so
        both packages choose alike; calibrate it per deployment.
      slot_cost: relative cost of one probed (table, probe, slot) against
        one reranked candidate in the plan ordering.
      max_K / max_L: geometry caps of the build-time solve.
      max_hashes: build-time budget on K·L; K walks down until K·L fits.
      table: optional :class:`repro_torch.tuner.TuningTable` prior.
      profile_skew: the weight-skew coordinate of this planner's workload
        in the table's profile space (1.0: the default weights).
      confirm_slack: recall slack the confirmation query of a prior plan
        tolerates.
    """

    weights: torch.Tensor | None = None
    candidates_per_ms: float = 2000.0
    slot_cost: float = 0.02
    max_K: int = 32
    max_L: int = 256
    max_hashes: int = 512
    table: object | None = None
    profile_skew: float = 1.0
    confirm_slack: float = 0.02

    # -- shared sampling -----------------------------------------------------
    def _calibration_weights(self, generator: torch.Generator, m: int, d: int) -> torch.Tensor:
        if self.weights is None:
            return default_calibration_weights(generator, (m, d))
        w = torch.as_tensor(self.weights, dtype=torch.float32).cpu()
        return torch.broadcast_to(w, (m, d)).contiguous()

    def _sample(self, generator: torch.Generator, data: torch.Tensor, m: int, jitter: float):
        """Deterministic (queries, weights) calibration sample on ``data``'s
        device: data rows JITTERED by one lattice cell (a raw row's bucket
        key exists in every table by construction; a held-out query can
        land in an empty bucket). Drawn on the CPU from ``generator``."""
        n, d = data.shape
        m = min(m, n)
        rows = torch.randperm(n, generator=generator)[:m]
        jit = torch.rand((m, d), generator=generator) * (2.0 * jitter) - jitter
        ws = self._calibration_weights(generator, m, d)
        dev = data.device
        return data[rows.to(dev)] + jit.to(dev), ws.to(dev)

    # -- build-time: theory inversion ---------------------------------------
    def plan_config(
        self,
        data: torch.Tensor,
        quality: QualitySpec,
        family: str = "auto",
        M: int = 32,
        space: BoundedSpace | None = None,
    ) -> IndexConfig:
        """Derive a full :class:`IndexConfig` from a data sample + targets.

        ``family="auto"`` solves both families and keeps the lower rho;
        ``space`` defaults to the data's bounding box at resolution
        ``M / (hi - lo)``. With a tuning ``table``, a frontier geometry for
        the matching data profile replaces the theory inversion.
        Deterministic given (data, quality.seed)."""
        from repro_torch.kernels import ops

        data = torch.as_tensor(data)
        n, d = data.shape
        generator = planning_generator(_ZERO_KEY, quality.seed, 0)
        if space is None:
            lo = float(torch.min(data))
            hi = float(torch.max(data))
            if hi <= lo:
                hi = lo + 1.0
            space = BoundedSpace(lo, hi, M / (hi - lo))
        M_eff = max(space.M, 1)
        prior_cfg = self._config_from_prior(n, d, quality, family, M_eff, space)
        if prior_cfg is not None:
            return prior_cfg
        data = data.to(torch.float32)
        qs, ws = self._sample(generator, data, quality.calibration_queries, jitter=1.0 / space.t)

        # k-NN radii IN LATTICE UNITS (hashing sees levels); +1: each
        # jittered query's source row sits at ~zero distance
        levels = transforms.discretize(data, space).to(torch.float32).contiguous()
        qlevels = transforms.discretize(qs, space).to(torch.float32).contiguous()
        kk = min(quality.k + 1, n)
        nn_d, _ = ops.wl1_scan_topk(levels, qlevels, ws.contiguous(), kk)
        r1 = torch.clamp(nn_d[:, kk - 1], min=1e-6)  # (m,) per-query operating radii
        r2 = quality.approx_c * r1

        candidates = ("theta", "l2") if family == "auto" else (family,)
        best = None
        for fam in candidates:
            sol = self._solve_family(fam, r1, r2, M_eff, d, ws, n, quality)
            if sol is not None and (best is None or sol["rho"] < best["rho"]):
                best = sol
        if best is None:
            raise ValueError(
                f"planner: no hash family yields usable collision probabilities "
                f"at the sampled operating radii (family={family!r}) — the "
                f"sample's neighbour distances may be degenerate; widen "
                f"approx_c or pass an explicit IndexConfig"
            )
        # per-table window: expected far collisions n*P2^K plus the k
        # neighbours, 8x headroom, a power of two in [32, 1024]
        exp_far = n * best["P2"] ** best["K"]
        C = int(min(1024, max(32, 2 ** math.ceil(math.log2(8 * (exp_far + quality.k))))))
        return IndexConfig(d=d, M=M_eff, K=best["K"], L=best["L"], family=best["family"],
                           W=best["W"], max_candidates=C, space=space)

    # collision prob the near-radius solve anchors W to: p_l2(s, c_star * s)
    # == _P1_GOAL for any s (Eq 4 depends only on W/s)
    _P1_GOAL = 0.9

    def _solve_family(self, fam: str, r1, r2, M, d, ws, n, quality):
        """One family's Thm 1 solve over PER-QUERY operating radii (r1/r2
        (m,) lattice radii, ws (m, d) weights): near probabilities at their
        25th percentile, far ones at the median. None when they degenerate."""
        W = 4.0
        if fam == "l2":
            s1 = theory.l2_distance_from_wl1(r1, M, d, ws)  # (m,)
            s2 = theory.l2_distance_from_wl1(r2, M, d, ws)
            if not bool(torch.all((s1 > 0) & (s2 > s1))):
                return None
            c_star = 1.0 / theory.invert_p_l2(self._P1_GOAL, 1.0)
            W = c_star * float(quantile_f32(s1, 0.75))
            p1 = theory.p_l2(s1, W)
            p2 = theory.p_l2(s2, W)
        else:
            p1 = theory.collision_prob_theta(r1, M, d, ws)
            p2 = theory.collision_prob_theta(r2, M, d, ws)
        p1 = np.clip(p1.detach().cpu().numpy().astype(np.float64), 1e-9, 1 - 1e-9)
        P1 = float(np.quantile(p1, 0.25))
        P2 = float(median_f32(p2))
        if not (0.0 < P2 < P1 < 1.0):
            return None
        max_K = self.max_K
        fam_cap = get_family(fam).max_K
        if fam_cap is not None:
            max_K = min(max_K, fam_cap)
        goal = max(quality.recall_target, 1.0 - quality.fail_prob)
        K = theory.solve_K(P2, n, max_K)
        while True:
            L = self._solve_L(p1, K, goal)
            if K == 1 or K * L <= self.max_hashes:
                break
            K -= 1
        return {"family": fam, "W": W, "P1": P1, "P2": P2, "K": K, "L": L,
                "rho": math.log(P1) / math.log(P2)}

    def _solve_L(self, p1_samples: np.ndarray, K: int, goal: float) -> int:
        """Smallest L <= max_L with mean_i[1 - (1 - p1_i^K)^L] >= goal
        (bisection on the monotone success curve, in f64; max_L when
        unreachable)."""
        miss = 1.0 - p1_samples**K

        def mean_success(L: int) -> float:
            return float(np.mean(1.0 - miss**L))

        if mean_success(self.max_L) < goal:
            return self.max_L
        lo, hi = 1, self.max_L
        while lo < hi:
            mid = (lo + hi) // 2
            if mean_success(mid) >= goal:
                hi = mid
            else:
                lo = mid + 1
        return lo

    # screening factors a quantized index's ladder crosses its rungs with
    _SCREEN_ALPHAS = (2.0, 4.0)

    # streamed rungs need at least this many exit groups (one group IS the
    # monolithic tail, which the engine folds early exit onto)
    _EXIT_GROUP = 8
    _MIN_EXIT_GROUPS = 2

    # -- query-time: empirical calibration ----------------------------------
    def _plan_ladder(self, cfg: IndexConfig, k: int, exit_slack: float = 0.0) -> list:
        """The candidate execution plans, cheapest intent first: single
        probe at shrinking windows, multiprobe at growing probe counts;
        with ``exit_slack`` > 0 an early-exit twin of every rung whose
        lattice spans ``_MIN_EXIT_GROUPS`` groups; on quantized storage a
        screened twin (``_SCREEN_ALPHAS``) of every non-streamed rung."""
        C = cfg.max_candidates
        windows = sorted({max(C >> s, min(C, max(2 * k, 16))) for s in (3, 2, 1, 0)})
        ladder = [PlannedSpec(k=k, mode="probe", max_candidates=c) for c in windows]
        if get_family(cfg.family).supports_multiprobe:
            max_flips = min(3, cfg.K)
            cap = n_flip_subsets(cfg.K, max_flips)
            for p in (2, 4, 8, 16, 32):
                if p <= cap:
                    ladder.append(PlannedSpec(k=k, mode="multiprobe", n_probes=p,
                                              max_flips=max_flips, max_candidates=C))
        if exit_slack > 0.0:
            ladder += [
                dataclasses.replace(rung, early_exit=True, exit_group=self._EXIT_GROUP,
                                    exit_slack=exit_slack)
                for rung in list(ladder)
                if cfg.L * rung.n_probes >= self._MIN_EXIT_GROUPS * self._EXIT_GROUP
            ]
        if cfg.storage != "f32":
            ladder += [
                dataclasses.replace(rung, screen_alpha=alpha)
                for rung in list(ladder)
                if not rung.early_exit  # screening folds streaming off
                for alpha in self._SCREEN_ALPHAS
            ]
        return ladder

    def _plan_cost(self, cfg: IndexConfig, plan: PlannedSpec, mean_cand: float) -> float:
        """Deterministic cost: reranked candidates + charged probe slots. A
        screened plan pays the proxy pass at the compressed byte ratio plus
        the exact rerank of ``ceil(k·α)`` survivors; an early-exit plan
        pays only its calibrated share of the L·P window lattice."""
        from repro_torch.quant import bytes_per_value

        slots = cfg.L * plan.n_probes * plan.max_candidates
        if plan.early_exit and plan.expected_tables == plan.expected_tables:
            slots *= min(1.0, plan.expected_tables / _n_windows(cfg, plan))
        if plan.screen_alpha:
            keep = max(plan.k, math.ceil(plan.k * plan.screen_alpha))
            ratio = bytes_per_value(cfg.storage) / 4.0
            rerank = mean_cand * ratio + min(mean_cand, float(keep))
        else:
            rerank = mean_cand
        return rerank + self.slot_cost * slots

    def _calibration_sample(self, index, quality: QualitySpec):
        """The shared calibration set-up (the full ladder and the prior's
        confirmation use the same evidence): jittered data-row queries and
        weights, and the exact oracle's answer. Quantized storage samples
        from the DECODED rows."""
        from repro_torch import quant

        data = quant.decode_table(index.state.data, index.state.scales)
        cfg = index.config
        generator = planning_generator(index.build_key, quality.seed)
        qs, ws = self._sample(generator, data, quality.calibration_queries,
                              jitter=1.0 / cfg.space.t)
        exact = index.query(qs, ws, QuerySpec(k=quality.k, mode="exact"))
        return qs, ws, exact

    def _operating_success(self, cfg: IndexConfig, exact, ws) -> float:
        """Thm 1 success bound at the observed operating radius (the median
        kth distance, raw units scaled by t into lattice units)."""
        kth = exact.dists[:, -1]
        r_op = float(median_f32(torch.where(torch.isfinite(kth), kth, torch.zeros_like(kth))))
        r_op *= cfg.space.t
        w_ref = torch.mean(torch.abs(ws), dim=0).cpu()
        p1 = self._collision_prob(cfg, r_op, w_ref)
        return float(1.0 - (1.0 - min(max(p1, 1e-12), 1 - 1e-12) ** cfg.K) ** cfg.L)

    def _calibrate(self, index, quality: QualitySpec):
        """Run EVERY ladder rung through ``index.query`` against the exact
        oracle. Returns ``(scored, success)``: ``(rung, recall, mean_cand,
        cost)`` tuples and the Thm 1 bound at the operating radius."""
        from repro_torch.distance import recall_at_k

        cfg = index.config
        qs, ws, exact = self._calibration_sample(index, quality)
        success = self._operating_success(cfg, exact, ws)
        scored = []
        for rung in self._plan_ladder(cfg, quality.k, exit_slack=quality.fail_prob):
            res = index.query(qs, ws, rung)
            recall = float(recall_at_k(res.ids, exact.ids, quality.k))
            mean_cand = mean_f32(res.n_candidates)
            # stamp expected_tables BEFORE costing, never leaving the NaN
            # default in a memoized plan (nan != nan breaks save/load ==)
            rung = dataclasses.replace(rung, expected_tables=(
                mean_f32(res.tables_probed) if res.tables_probed is not None
                else float(_n_windows(cfg, rung))
            ))
            scored.append((rung, recall, mean_cand, self._plan_cost(cfg, rung, mean_cand)))
        return scored, success

    def _select(self, scored, quality: QualitySpec):
        """The cheapest calibrated rung meeting the recall target (then the
        latency budget); best effort with a warning when none does."""
        budget = None
        if quality.latency_budget_ms is not None:
            budget = quality.latency_budget_ms * self.candidates_per_ms
        meets_recall = [s for s in scored if s[1] >= quality.recall_target - 1e-9]
        feasible = [s for s in meets_recall if budget is None or s[2] <= budget]
        if feasible:
            return min(feasible, key=lambda s: s[3])
        if meets_recall:
            plan, recall, mean_cand, cost = min(meets_recall, key=lambda s: s[3])
            warnings.warn(
                f"planner: no plan meets recall_target={quality.recall_target} "
                f"within latency_budget_ms={quality.latency_budget_ms} "
                f"(cheapest conforming plan examines ~{mean_cand:.0f} "
                f"candidates/query, budget admits {budget:.0f}); keeping the "
                f"recall target — relax one of the two",
                stacklevel=2,
            )
            return plan, recall, mean_cand, cost
        plan, recall, mean_cand, cost = max(scored, key=lambda s: (s[1], -s[3]))
        warnings.warn(
            f"planner: no execution plan reaches recall_target="
            f"{quality.recall_target} on this index "
            f"(best calibrated recall {recall:.3f} via {plan.mode}); "
            f"rebuild with a QualitySpec (or more tables / a wider "
            f"max_candidates window) to close the gap",
            stacklevel=2,
        )
        return plan, recall, mean_cand, cost

    @staticmethod
    def _stamp(scored_entry, success: float) -> PlannedSpec:
        rung, recall, mean_cand, _ = scored_entry
        return dataclasses.replace(rung, predicted_recall=recall, predicted_success=success,
                                   expected_candidates=mean_cand, provenance="calibrated")

    # -- empirical prior (offline tuning table) ------------------------------
    def _config_from_prior(self, n: int, d: int, quality: QualitySpec, family: str, M_eff: int,
                           space: BoundedSpace) -> IndexConfig | None:
        """Build geometry from the table's nearest-profile frontier: the
        cheapest entry meeting the goal over every candidate family's
        bucket. None when there is no table, no bucket, or no such entry."""
        if self.table is None:
            return None
        candidates = ("theta", "l2") if family == "auto" else (family,)
        goal = max(quality.recall_target, 1.0 - quality.fail_prob)
        entry = None
        for fam in candidates:
            bucket = self.table.nearest_bucket(fam, n, d, self.profile_skew)
            if bucket is None:
                continue
            e = self.table.best_entry(bucket, goal)
            if e is None:
                continue
            if entry is None or (e["cost"], e["trial_id"]) < (entry["cost"], entry["trial_id"]):
                entry = e
        if entry is None:
            return None
        return IndexConfig(d=d, M=M_eff, K=entry["K"], L=entry["L"], family=entry["family"],
                           W=float(entry["W"]), max_candidates=entry["window"], space=space)

    def _entry_matches_config(self, entry: dict, cfg: IndexConfig) -> bool:
        """A frontier entry's plan transfers only to an index whose built
        geometry matches the scanned trial's."""
        if entry["family"] != cfg.family or entry["K"] != cfg.K or entry["L"] != cfg.L:
            return False
        if cfg.family == "l2" and not math.isclose(float(entry["W"]), cfg.W, rel_tol=1e-6):
            return False
        if entry["window"] > cfg.max_candidates:
            return False
        if entry["n_probes"] > 1 and entry["n_probes"] > n_flip_subsets(cfg.K,
                                                                          entry["max_flips"]):
            return False
        return True

    def _plan_from_prior(self, index, quality: QualitySpec) -> PlannedSpec | None:
        """The plan of the nearest-profile frontier entry meeting the target,
        confirmed by ONE query of the calibration sample; None sends the
        caller to the full calibration."""
        if self.table is None:
            return None
        from repro_torch.distance import recall_at_k

        cfg = index.config
        bucket = self.table.nearest_bucket(cfg.family, index.n, cfg.d, self.profile_skew)
        if bucket is None:
            return None
        candidates = [e for e in bucket["entries"]
                      if e["recall"] >= quality.recall_target - 1e-9
                      and self._entry_matches_config(e, cfg)]
        if not candidates:
            return None
        entry = min(candidates, key=lambda e: (e["cost"], e["trial_id"]))
        rung = PlannedSpec(
            k=quality.k,
            mode="multiprobe" if entry["n_probes"] > 1 else "probe",
            n_probes=entry["n_probes"] if entry["n_probes"] > 1 else 1,
            max_flips=entry["max_flips"] if entry["n_probes"] > 1 else 0,
            max_candidates=entry["window"],
            # tables older than the early-exit axes: off
            early_exit=bool(entry.get("early_exit", False)),
            exit_group=int(entry.get("exit_group") or 8),
            exit_slack=float(entry.get("exit_slack") or 0.0),
        )
        qs, ws, exact = self._calibration_sample(index, quality)
        res = index.query(qs, ws, rung)
        recall = float(recall_at_k(res.ids, exact.ids, quality.k))
        if recall < quality.recall_target - self.confirm_slack:
            return None  # the prior overpromised on THIS index
        mean_cand = mean_f32(res.n_candidates)
        if quality.latency_budget_ms is not None and mean_cand > (
            quality.latency_budget_ms * self.candidates_per_ms
        ):
            return None  # budget-infeasible prior: let _select arbitrate
        return dataclasses.replace(
            rung,
            predicted_recall=recall,
            predicted_success=self._operating_success(cfg, exact, ws),
            expected_candidates=mean_cand,
            expected_tables=(mean_f32(res.tables_probed) if res.tables_probed is not None
                             else float(_n_windows(cfg, rung))),
            provenance="prior",
        )

    def plan_query(self, index, quality: QualitySpec) -> PlannedSpec:
        """Resolve the execution plan for ``quality`` on ``index``: a
        confirmed prior (``provenance="prior"``) when the tuning table
        covers the index, else the cheapest calibrated rung meeting the
        target (best effort + a warning when none does)."""
        planned = self._plan_from_prior(index, quality)
        if planned is not None:
            return planned
        scored, success = self._calibrate(index, quality)
        return self._stamp(self._select(scored, quality), success)

    def plan_ladder(self, index, quality: QualitySpec) -> tuple:
        """The degradation ladder for ``quality``: rung 0 is the plan
        ``plan_query`` picks without a prior; every later rung is strictly
        cheaper under the cost model, most expensive first, each stamped
        with its calibrated recall. Always one full calibration pass."""
        scored, success = self._calibrate(index, quality)
        chosen = self._select(scored, quality)
        cheaper = sorted((s for s in scored if s[3] < chosen[3]), key=lambda s: -s[3])
        return tuple(self._stamp(s, success) for s in [chosen, *cheaper])

    @staticmethod
    def _collision_prob(cfg: IndexConfig, r: float, w) -> float:
        """Eq 25/27 at distance r under weight profile w (family dispatch)."""
        if cfg.family == "l2":
            return float(theory.collision_prob_l2(r, cfg.M, cfg.d, w, cfg.W))
        return float(theory.collision_prob_theta(r, cfg.M, cfg.d, w))
