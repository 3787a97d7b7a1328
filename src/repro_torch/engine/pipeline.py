"""The execution pipeline: key enumeration → sources → one tail.

Counterpart of ``repro.engine.pipeline`` for the sealed index:

  1. ``probe_keys`` — the (b, L, P) probing sequence: each table's own
     bucket key (mode "probe", P = 1) or the query-directed multiprobe
     sequence (mode "multiprobe");
  2. ``sources_for`` — the sealed sorted-table window source;
  3. ``execute`` — merge the blocks, dedupe by sort (unique ids packed
     first; the unique count is the paper's sublinearity metric), then,
     for a quantized table with ``screen_alpha`` > 0, a proxy screen over
     the encoded rows that keeps ``ceil(k·α)`` survivors, then the fused
     gather/rerank/top-k kernel over the decoded rows.

``dispatch``/``query`` wire the stages for modes "probe" and "multiprobe",
and run the streaming scan kernel for mode "exact" (over the decoded table
for quantized storage). Early exit and the mutable segments raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch import not_ported, quant
from repro_torch.core import transforms
from repro_torch.core.index import (
    ALSHIndex,
    IndexConfig,
    QueryResult,
    _dedupe_candidates,
    _keys_for,
)
from repro_torch.core.multiprobe import MAX_FLIPS, N_PROBES, multiprobe_keys_for
from repro_torch.engine.sources import CandidateSource, SortedTableSource
from repro_torch.kernels import ops


def probe_keys(
    state: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
) -> torch.Tensor:
    """The (b, L, P) probing sequence of a query batch: mode "probe" gives
    each query's own bucket key per table (P = 1); mode "multiprobe" the
    query-directed perturbation sequence (P <= n_probes, clamped by the
    family's reachable-subset count)."""
    if mode == "multiprobe":
        return multiprobe_keys_for(state, queries, weights, cfg, n_probes, max_flips)
    if mode != "probe":
        raise ValueError(f"probe_keys: mode must be 'probe' or 'multiprobe', got {mode!r}")
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
    scales: torch.Tensor | None = None,
    screen_alpha: float = 0.0,
) -> QueryResult:
    """Merge source blocks → dedupe → [quantized screen →] fused
    gather/rerank/top-k over ``data`` (f32 or an encoded payload).

    With ``screen_alpha`` > 0 the same fused kernel first ranks every
    candidate by the compressed-domain proxy distance (``quant.proxy_query``:
    no decode, the gather moves encoded bytes) and only the top
    ``ceil(k·α)`` survivors reach the exact rerank. The caller passes α = 0
    for f32 storage and exact mode (``query`` folds it)."""
    blocks = [s.emit(queries, weights) for s in sources]
    cand = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    cand, n_candidates = _dedupe_candidates(cand, n_valid)
    keep = quant.screen_keep(k, screen_alpha, cand.shape[1])
    if keep:
        qp, wp = quant.proxy_query(queries, weights, data.dtype, scales)
        _, surv = ops.gather_rerank_topk(data, cand, qp, wp, keep)
        # survivors come back -1-padded; map them to the candidate sentinel
        # so invalid slots stay invalid (never row 0)
        cand = torch.where(surv >= 0, surv, torch.full_like(surv, n_valid))
    dists, ids = ops.gather_rerank_topk(data, cand, queries, weights, k, scales=scales)
    return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)


def dispatch(
    state: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
    screen_alpha: float = 0.0,
) -> QueryResult:
    """One query over a sealed index: ``mode`` "probe", "multiprobe" (ALSH)
    or "exact" (streaming scan over the decoded table; ``cfg`` may be
    None). Runs on ``state``'s device."""
    if mode == "exact":
        table = quant.decode_table(state.data, state.scales)  # f32: the same tensor
        dists, ids = ops.wl1_scan_topk(table, queries, weights, k)
        n_candidates = torch.full((queries.shape[0],), state.n, dtype=torch.int32,
                                  device=queries.device)
        return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)
    keys = probe_keys(state, queries, weights, cfg, mode=mode, n_probes=n_probes,
                      max_flips=max_flips)
    srcs = sources_for(state, cfg, keys)
    return execute(srcs, state.data, queries, weights, k, n_valid=state.n,
                   scales=state.scales, screen_alpha=screen_alpha)


def query(
    state: ALSHIndex,
    delta,
    tombstones,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
    screen_alpha: float = 0.0,
    early_exit: bool = False,
) -> QueryResult:
    """The engine entry every consumer shares (same signature prefix as the
    reference). Queries move to the index's device as contiguous f32. The
    screen is off for exact mode and f32 storage, as the reference's
    ``normalize_static_args`` folds it."""
    if delta is not None or tombstones is not None:
        raise not_ported("a mutable index (delta segment / tombstones)", "Queue A item 7")
    if early_exit:
        raise not_ported("early_exit (streamed adaptive probing)", "Queue A item 8")
    if mode == "exact" or state.data.dtype == torch.float32:
        screen_alpha = 0.0
    dev = state.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    weights = weights.to(device=dev, dtype=torch.float32).contiguous()
    return dispatch(state, queries, weights, cfg, k=k, mode=mode, n_probes=n_probes,
                    max_flips=max_flips, screen_alpha=screen_alpha)
