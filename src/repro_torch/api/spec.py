"""QuerySpec / QualitySpec / PlannedSpec / UpdateSpec — counterpart of
``repro.api.spec``.

The specs keep the reference's fields and validation, so a spec that is
invalid there is invalid here with the same message. ``QuerySpec`` states
the mechanism; :class:`QualitySpec` states the scenario (recall target,
approximation factor, failure bound, latency budget) and
:class:`~repro_torch.api.planner.Planner` resolves it into a
:class:`PlannedSpec`, itself a valid ``Index.query`` spec:
``index.query(q, w, quality)`` equals ``index.query(q, w,
index.plan(quality))`` bit for bit.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.multiprobe import MAX_FLIPS, N_PROBES

MODES = ("exact", "probe", "multiprobe")
IMPLS = ("auto", "gather", "onehot")


@dataclasses.dataclass(frozen=True)
class QuerySpec:
    """How to execute a query: ``k`` neighbours; ``mode`` "probe" (the
    paper's single-probe ALSH), "multiprobe" (``n_probes`` buckets per
    table, flipping up to ``max_flips`` bits) or "exact" (streaming scan,
    the oracle); ``screen_alpha`` >= 1 screens quantized storage down to
    ``ceil(k·α)`` survivors before the exact rerank (0: off);
    ``early_exit`` streams the probe windows ``exit_group`` at a time and
    stops each query at the geometric bound or, with ``exit_slack`` > 0, at
    the Eq 25/27 confidence bound (a miss-probability budget). ``impl``
    (probe mode only) picks the query projection: "auto" runs the
    ``alsh_project`` kernel; "gather" and "onehot" run the reference's two
    plain formulations, on CPU tensors only — on the card the hand kernel is
    the one projection, and the engine raises for any other."""

    k: int = 1
    mode: str = "probe"
    n_probes: int = N_PROBES
    max_flips: int = MAX_FLIPS
    impl: str = "auto"
    screen_alpha: float = 0.0
    early_exit: bool = False
    exit_group: int = 8
    exit_slack: float = 0.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"QuerySpec.mode must be one of {MODES}, got {self.mode!r}")
        if not isinstance(self.k, int) or self.k <= 0:
            raise ValueError(f"QuerySpec.k must be a positive int, got {self.k!r}")
        if self.screen_alpha != 0.0 and not self.screen_alpha >= 1.0:
            raise ValueError(
                f"QuerySpec.screen_alpha must be 0 (screen off) or >= 1.0 "
                f"(keep ceil(k·α) proxy survivors), got {self.screen_alpha!r}"
            )
        if self.impl not in IMPLS:
            raise ValueError(f"QuerySpec.impl must be one of {IMPLS}, got {self.impl!r}")
        if self.impl != "auto" and self.mode != "probe":
            raise ValueError(
                f"QuerySpec.impl={self.impl!r} only applies to mode='probe' "
                f"(got mode={self.mode!r}, which would silently ignore it)"
            )
        if self.mode == "multiprobe":
            if not isinstance(self.n_probes, int) or self.n_probes <= 0:
                raise ValueError(
                    f"QuerySpec.n_probes must be a positive int, got {self.n_probes!r}"
                )
            if not isinstance(self.max_flips, int) or self.max_flips < 0:
                raise ValueError(
                    f"QuerySpec.max_flips must be a non-negative int, got {self.max_flips!r}"
                )
        if not isinstance(self.early_exit, bool):
            raise ValueError(f"QuerySpec.early_exit must be a bool, got {self.early_exit!r}")
        if not isinstance(self.exit_group, int) or self.exit_group <= 0:
            raise ValueError(
                f"QuerySpec.exit_group must be a positive int, got {self.exit_group!r}"
            )
        if not (0.0 <= self.exit_slack < 1.0):
            raise ValueError(
                f"QuerySpec.exit_slack must be a miss-probability budget in "
                f"[0, 1), got {self.exit_slack!r}"
            )
        if self.early_exit and self.mode == "exact":
            raise ValueError(
                "QuerySpec.early_exit does not apply to mode='exact' (the "
                "streaming scan already visits every row exactly once)"
            )


@dataclasses.dataclass(frozen=True)
class QualitySpec:
    """What quality the caller needs; the planner derives the mechanism.

    ``k`` neighbours (recall is measured @k); ``recall_target`` the least
    recall@k against the exact scan the chosen plan must reach on the
    calibration sample; ``approx_c`` the Thm 1 factor c > 1 (R2 = c·R1);
    ``fail_prob`` the per-query failure bound of the table-count solve (and
    the early-exit rungs' miss budget); ``latency_budget_ms`` an optional
    per-query budget, applied through the linear cost model
    ``Planner.candidates_per_ms`` (a knee-point selector, not an SLA);
    ``calibration_queries`` the calibration sample's size; ``seed`` its
    seed. Planning is deterministic given (index, ``seed``)."""

    k: int = 10
    recall_target: float = 0.9
    approx_c: float = 2.0
    fail_prob: float = 0.1
    latency_budget_ms: float | None = None
    calibration_queries: int = 64
    seed: int = 0

    def __post_init__(self):
        if not isinstance(self.k, int) or self.k <= 0:
            raise ValueError(f"QualitySpec.k must be a positive int, got {self.k!r}")
        if not (0.0 < self.recall_target <= 1.0):
            raise ValueError(
                f"QualitySpec.recall_target must be in (0, 1], got {self.recall_target!r}"
            )
        if not self.approx_c > 1.0:
            raise ValueError(
                f"QualitySpec.approx_c must be > 1 (Thm 1 needs R2 > R1), got {self.approx_c!r}"
            )
        if not (0.0 < self.fail_prob < 1.0):
            raise ValueError(f"QualitySpec.fail_prob must be in (0, 1), got {self.fail_prob!r}")
        if self.latency_budget_ms is not None and not self.latency_budget_ms > 0:
            raise ValueError(
                f"QualitySpec.latency_budget_ms must be positive (or None), "
                f"got {self.latency_budget_ms!r}"
            )
        if not isinstance(self.calibration_queries, int) or self.calibration_queries <= 0:
            raise ValueError(
                f"QualitySpec.calibration_queries must be a positive int, "
                f"got {self.calibration_queries!r}"
            )


@dataclasses.dataclass(frozen=True)
class PlannedSpec:
    """A QualitySpec resolved to concrete execution parameters.

    Frozen and hashable; persists in the index manifest and is a valid
    ``Index.query`` spec (``query(q, w, quality)`` and ``query(q, w,
    plan)`` run the same query).

    Attributes:
      k: neighbours returned.
      mode: "probe" | "multiprobe".
      n_probes / max_flips: multiprobe knobs (1 / 0 in probe mode).
      max_candidates: the per-table probe window — never wider than the
        built ``IndexConfig.max_candidates`` (the build padding caps it).
      predicted_recall: calibrated recall@k on the planning sample.
      predicted_success: Thm 1 success bound 1-(1-P1^K)^L at the calibrated
        operating radius.
      expected_candidates: mean unique candidates per calibration query.
      screen_alpha: the quantized screen the plan runs with (0.0 on f32
        storage, where the ladder proposes no screen).
      early_exit / exit_group / exit_slack: the streamed tail's knobs (see
        :class:`QuerySpec`); early-exit rungs take ``exit_slack`` =
        ``QualitySpec.fail_prob``.
      expected_tables: mean probe windows visited per calibration query
        (== L·P when the plan never exits early).
      provenance: "calibrated" (the full ladder ran on this index) or
        "prior" (taken from an offline tuning table and accepted after one
        confirmation query).
    """

    k: int
    mode: str
    n_probes: int = 1
    max_flips: int = 0
    max_candidates: int = 64
    predicted_recall: float = float("nan")
    predicted_success: float = float("nan")
    expected_candidates: float = float("nan")
    screen_alpha: float = 0.0
    early_exit: bool = False
    exit_group: int = 8
    exit_slack: float = 0.0
    expected_tables: float = float("nan")
    provenance: str = "calibrated"

    def __post_init__(self):
        if self.mode not in ("probe", "multiprobe"):
            raise ValueError(
                f"PlannedSpec.mode must be 'probe' or 'multiprobe', got {self.mode!r}"
            )
        if self.screen_alpha != 0.0 and not self.screen_alpha >= 1.0:
            raise ValueError(
                f"PlannedSpec.screen_alpha must be 0 (screen off) or >= 1.0, "
                f"got {self.screen_alpha!r}"
            )
        if self.provenance not in ("calibrated", "prior"):
            raise ValueError(
                f"PlannedSpec.provenance must be 'calibrated' or 'prior', "
                f"got {self.provenance!r}"
            )
        for field in ("k", "n_probes", "max_candidates"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"PlannedSpec.{field} must be a positive int, got {v!r}")
        if not isinstance(self.max_flips, int) or self.max_flips < 0:
            raise ValueError(
                f"PlannedSpec.max_flips must be a non-negative int, got {self.max_flips!r}"
            )
        if not isinstance(self.early_exit, bool):
            raise ValueError(f"PlannedSpec.early_exit must be a bool, got {self.early_exit!r}")
        if not isinstance(self.exit_group, int) or self.exit_group <= 0:
            raise ValueError(
                f"PlannedSpec.exit_group must be a positive int, got {self.exit_group!r}"
            )
        if not (0.0 <= self.exit_slack < 1.0):
            raise ValueError(f"PlannedSpec.exit_slack must be in [0, 1), got {self.exit_slack!r}")

    def to_query_spec(self) -> QuerySpec:
        """The mechanism-level spec this plan executes as."""
        if self.mode == "multiprobe":
            return QuerySpec(
                k=self.k, mode="multiprobe", n_probes=self.n_probes, max_flips=self.max_flips,
                screen_alpha=self.screen_alpha, early_exit=self.early_exit,
                exit_group=self.exit_group, exit_slack=self.exit_slack,
            )
        return QuerySpec(
            k=self.k, mode="probe", screen_alpha=self.screen_alpha, early_exit=self.early_exit,
            exit_group=self.exit_group, exit_slack=self.exit_slack,
        )

    def effective_config(self, cfg):
        """``cfg`` with this plan's probe window applied (never wider than
        the built window — the sort-time perm padding caps it)."""
        if self.max_candidates == cfg.max_candidates:
            return cfg
        if self.max_candidates > cfg.max_candidates:
            raise ValueError(
                f"PlannedSpec.max_candidates={self.max_candidates} exceeds the "
                f"built IndexConfig.max_candidates={cfg.max_candidates} — this "
                f"plan was made for a different index geometry"
            )
        return dataclasses.replace(cfg, max_candidates=self.max_candidates)


@dataclasses.dataclass(frozen=True)
class UpdateSpec:
    """Build-time mutability policy. ``delta_capacity=C`` > 0 reserves C
    delta slots and makes the index mutable (``Index.insert``/``delete``/
    ``compact``); ``delta_capacity=0`` (the default) is a sealed index.
    ``compact_threshold`` is the delta fill share at which
    ``Index.needs_compact`` turns true (advisory: the caller compacts)."""

    delta_capacity: int = 0
    compact_threshold: float = 0.75

    def __post_init__(self):
        if not isinstance(self.delta_capacity, int) or self.delta_capacity < 0:
            raise ValueError(
                f"UpdateSpec.delta_capacity must be a non-negative int, "
                f"got {self.delta_capacity!r}"
            )
        if not (0.0 < self.compact_threshold <= 1.0):
            raise ValueError(
                f"UpdateSpec.compact_threshold must be in (0, 1], got {self.compact_threshold!r}"
            )

    @property
    def mutable(self) -> bool:
        return self.delta_capacity > 0
