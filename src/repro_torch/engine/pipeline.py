"""The execution pipeline: key enumeration → sources → one tail.

Counterpart of ``repro.engine.pipeline`` for the sealed f32 index:

  1. ``probe_keys`` — the (b, L, 1) single-probe key of each table;
  2. ``sources_for`` — the sealed sorted-table window source;
  3. ``execute`` — merge the blocks, dedupe by sort (unique ids packed
     first; the unique count is the paper's sublinearity metric), then the
     fused gather/rerank/top-k kernel.

``dispatch``/``query`` wire the stages for mode "probe", and run the
streaming scan kernel for mode "exact". Multiprobe, early exit, the
quantized screen and the mutable segments raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch import not_ported
from repro_torch.core import transforms
from repro_torch.core.index import (
    ALSHIndex,
    IndexConfig,
    QueryResult,
    _dedupe_candidates,
    _keys_for,
)
from repro_torch.engine.sources import CandidateSource, SortedTableSource
from repro_torch.kernels import ops


def probe_keys(
    state: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    mode: str = "probe",
) -> torch.Tensor:
    """The (b, L, P) probing sequence of a query batch; mode "probe" gives
    each query's own bucket key per table (P = 1)."""
    if mode == "multiprobe":
        raise not_ported("mode='multiprobe'", "Queue A item 5")
    if mode != "probe":
        raise ValueError(f"probe_keys: mode must be 'probe', got {mode!r}")
    qlevels = transforms.discretize(queries, cfg.space)
    keys = _keys_for(qlevels, weights, state.tables, cfg, state.mixers)
    return keys[:, :, None]


def sources_for(state: ALSHIndex, cfg: IndexConfig, keys: torch.Tensor) -> list[CandidateSource]:
    """The candidate sources of a sealed index view: its table windows."""
    return [SortedTableSource(state, cfg, keys)]


def execute(
    sources: list[CandidateSource],
    data: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    n_valid: int,
) -> QueryResult:
    """Merge source blocks → dedupe → fused gather/rerank/top-k over ``data``."""
    blocks = [s.emit(queries, weights) for s in sources]
    cand = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    cand, n_candidates = _dedupe_candidates(cand, n_valid)
    dists, ids = ops.gather_rerank_topk(data, cand, queries, weights, k)
    return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)


def dispatch(
    state: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
) -> QueryResult:
    """One query over a sealed index: ``mode`` "probe" (ALSH) or "exact"
    (streaming scan; ``cfg`` may be None). Runs on ``state``'s device."""
    if mode == "exact":
        dists, ids = ops.wl1_scan_topk(state.data, queries, weights, k)
        n_candidates = torch.full((queries.shape[0],), state.n, dtype=torch.int32,
                                  device=queries.device)
        return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)
    keys = probe_keys(state, queries, weights, cfg, mode=mode)
    srcs = sources_for(state, cfg, keys)
    return execute(srcs, state.data, queries, weights, k, n_valid=state.n)


def query(
    state: ALSHIndex,
    delta,
    tombstones,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
    screen_alpha: float = 0.0,
    early_exit: bool = False,
) -> QueryResult:
    """The engine entry every consumer shares (same signature prefix as the
    reference). Queries move to the index's device as contiguous f32."""
    if delta is not None or tombstones is not None:
        raise not_ported("a mutable index (delta segment / tombstones)", "Queue A item 7")
    if screen_alpha:
        raise not_ported("screen_alpha (quantized proxy screen)", "Queue A item 6")
    if early_exit:
        raise not_ported("early_exit (streamed adaptive probing)", "Queue A item 8")
    dev = state.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    weights = weights.to(device=dev, dtype=torch.float32).contiguous()
    return dispatch(state, queries, weights, cfg, k=k, mode=mode)
