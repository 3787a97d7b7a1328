"""Per-query diagnostics of ``Index.explain`` — counterpart of the
``QueryReport`` of ``repro.api.planner``.

Only the report is ported. The ``Planner`` that resolves a
:class:`~repro_torch.api.spec.QualitySpec` to a mechanism (calibration,
priors, plan memo) is ROADMAP.md Queue A item 10; until then ``Index``
raises ``NotImplementedError`` for a ``QualitySpec``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.api.spec import QualitySpec


@dataclasses.dataclass
class QueryReport:
    """Per-query diagnostics from ``Index.explain``: the spec that ran, the
    theory prediction, and what actually happened.

    Attributes:
      spec: the spec that EXECUTED.
      quality: the QualitySpec the caller stated (None for mechanism specs;
        always None until the planner is ported).
      result: the :class:`~repro_torch.core.index.QueryResult` (the arrays
        ``Index.query`` returns — explain never changes the answer).
      predicted_success: (b,) Thm 1 success bound 1-(1-p1^K)^L per query,
        p1 = Eq 25/27 at the query's OWN weights and observed top-1
        distance (0.0 where the query returned nothing); for multiprobe the
        single-probe lower bound.
      n_candidates: (b,) unique candidates examined (the sublinearity metric).
      truncated_tables: (b,) probed buckets whose window exceeded
        ``max_candidates`` (candidates dropped before the re-rank).
      n_invalid: (b,) sentinel result slots (ids == -1).
      provenance: how a planned spec was resolved (None for mechanism specs).
      plan_build_s: plan resolution seconds (None for mechanism specs).
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
