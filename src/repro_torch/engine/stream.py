"""Streamed early-exit tail: confidence-bounded adaptive probing.

Counterpart of ``repro.engine.stream``. The monolithic
:func:`repro_torch.engine.pipeline.execute` merges, dedupes and re-ranks all
L·P probe windows for every query. This tail streams the same windows a
group of ``exit_group`` at a time through the same primitives and stops
each query as soon as its running top-k is final:

  * **Window order** is quality-major: visit position ``j`` is probe rank
    ``j // L`` of table ``j % L``, so every own-bucket window (rank 0)
    streams before any perturbed one (:func:`window_order`).
  * **The loop** carries the running top-k heap ``(b, k)``, a per-query live
    mask and the probe/stop accounting. Each group probes its windows for
    every query (one batched window probe: the group's tables are the same
    for every query), maps the block of already-stopped queries to the
    sentinel, re-dedupes the heap ids into the block and re-ranks the
    ``(b, k + G·C)`` candidates with ``ops.gather_rerank_topk`` — the
    fused gather kernels, f32 or quantized, one or two segments.
  * **The stop predicate** runs per query after each group: geometric —
    with non-negative weights every distance is >= 0, so a full heap at
    ``kth <= 0`` cannot be beaten; confidence (only when ``exit_slack`` >
    0) — the Eq 25/27 estimate that a better-than-kth neighbour collided in
    none of the own-bucket windows probed so far is <= ``exit_slack``,
    computed in log space.

The reference runs the loop as one ``lax.while_loop`` whose condition is
``g < n_groups and any(live)``. Here the loop is on the host and reads
``live.any()`` once per group (one device sync per group), so a batch whose
queries have all stopped runs no further group. A fixed trip count would
spare the syncs and spend every group's work after all queries stopped; both
give the same answers, since a stopped query's block is all sentinels.

Bit-identity: every selection picks the k smallest candidates under the
(dist, id) order, so merging the heap into each group's deduped block keeps
"heap == k smallest of everything seen", and a full pass (no query stops)
returns the monolithic tail's answer bit for bit. ``n_candidates`` stays the
exact unique count through a per-query (b, n_tot + 1) seen mask (slot
n_tot is the sentinel sink): each merge adds its candidates not seen
before, where the reference sums the mask once at the end (a (b, n_tot)
reduction that costs a millisecond at the service width). ``tables_probed``
counts probe windows visited (tables when P = 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import theory
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    _dedupe_candidates,
    _delta_candidates,
    _mask_dead,
    _probe_one_table,
    delta_live_mask,
)
from repro_torch.kernels import ops

# stop_reason codes (stamped through QueryReport / serve --stats)
STOP_EXHAUSTED = 0  # every group streamed, no early stop
STOP_GEOMETRIC = 1  # running kth distance provably unbeatable
STOP_CONFIDENCE = 2  # Eq 25/27 miss estimate under the slack budget

# Eq 25/27 clip — the same as Index.explain's success stamping
_P1_EPS = 1e-12


def window_order(L: int, P: int, exit_group: int) -> tuple:
    """The quality-major visit order, padded to whole groups.

    Returns ``(tables, ranks, n_windows, n_groups)``: ``tables``/``ranks``
    are int32 arrays of length ``n_groups * exit_group`` giving each visit
    position's (table, probe rank); position ``j`` is ``(j % L, j // L)``.
    Padding repeats the LAST window, whose candidates then dedupe against
    the heap, so the result is unchanged.
    """
    n_windows = L * P
    n_groups = -(-n_windows // exit_group)
    j = np.minimum(np.arange(n_groups * exit_group), n_windows - 1)
    return (j % L).astype(np.int32), (j // L).astype(np.int32), n_windows, n_groups


def _miss_log_prob(r_raw: torch.Tensor, weights: torch.Tensor, cfg: IndexConfig,
                   tables_done: torch.Tensor) -> torch.Tensor:
    """log of the Eq 25/27 miss estimate: the probability that a point within
    running radius ``r_raw`` of its query collided with it in NONE of the
    ``tables_done`` own-bucket windows probed so far, at each query's own
    weights. Radii reach theory in lattice units (raw distance × space.t)."""
    r = r_raw * cfg.space.t
    if cfg.family == "l2":
        p1 = theory.collision_prob_l2(r, cfg.M, cfg.d, weights, cfg.W)
    else:
        p1 = theory.collision_prob_theta(r, cfg.M, cfg.d, weights)
    p1 = torch.clamp(p1, _P1_EPS, 1.0 - _P1_EPS)
    return tables_done * torch.log1p(-theory.int_pow(p1, cfg.K))


def stream_topk(
    state: ALSHIndex,
    delta: DeltaSegment | None,
    tombstones: torch.Tensor | None,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    keys: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    exit_group: int = 8,
    exit_slack: float = 0.0,
) -> QueryResult:
    """The streamed adaptive-probing tail (see the module docstring).

    ``keys`` is the (b, L, P) probing sequence of ``pipeline.probe_keys``,
    its P axis ordered by per-query probe quality. ``exit_group`` and
    ``exit_slack`` are the values ``pipeline.query`` leaves after its folds
    (at least two groups, no active quantized screen).
    """
    b, L, P = keys.shape
    dev = queries.device
    n_main = state.n
    cap = delta.capacity if delta is not None else 0
    n_tot = n_main + cap
    segmented = tombstones is not None or delta is not None
    if segmented and tombstones is None:
        tombstones = torch.zeros((n_tot,), dtype=torch.bool, device=dev)
    C = cfg.max_candidates
    G = exit_group
    tbl, ranks, n_windows, n_groups = window_order(L, P, G)
    tbl = torch.from_numpy(tbl).to(device=dev, dtype=torch.long)
    # per-query keys in visit order (b, n_groups*G): rank-major gather of the lattice
    kw = keys[:, tbl, torch.from_numpy(ranks).to(device=dev, dtype=torch.long)]
    main_data = state.data
    delta_data = delta.data if cap else None
    rows = torch.arange(b, device=dev)[:, None]

    # The delta seeds the heap outside the loop: it is one key-match source,
    # not a window stream (the final result is the k smallest over the delta
    # and all windows either way). seen[q, i]: candidate i already examined
    # for query q; slot n_tot is the sentinel sink. Each merge's candidates
    # are deduped and hold the heap, whose ids are all seen already, so the
    # unseen valid ids among them are exactly the block's new candidates:
    # counting those keeps n_candidates exact without reducing the mask.
    seen = torch.zeros((b, n_tot + 1), dtype=torch.bool, device=dev)
    n_cand = torch.zeros((b,), dtype=torch.int32, device=dev)

    def mark_new(cand: torch.Tensor) -> torch.Tensor:
        """Mark ``cand`` seen; (b,) int32 count of its valid ids not seen before."""
        idx = cand.long()
        new = (cand < n_tot) & ~seen[rows, idx]
        seen[rows, idx] = True
        return new.sum(dim=1, dtype=torch.int32)

    if cap:
        live_slots = delta_live_mask(delta, tombstones, n_main)
        dcand = _delta_candidates(keys, delta, live_slots, n_main, n_tot)
        cand0, _ = _dedupe_candidates(dcand, n_tot)
        heap_d, heap_i = ops.gather_rerank_topk(main_data, cand0, queries, weights, k,
                                                scales=scales, delta=delta_data)
        n_cand = n_cand + mark_new(cand0)
    else:
        heap_d = torch.full((b, k), float("inf"), dtype=torch.float32, device=dev)
        heap_i = torch.full((b, k), -1, dtype=torch.int32, device=dev)

    # geometric bound: with non-negative weights every wl1 distance is >= 0,
    # so a full heap at kth == 0 cannot be beaten (strict-< replace). Any
    # negative weight voids the bound: the rule never fires there.
    w_nonneg = (weights >= 0.0).all(dim=1)
    live = torch.ones((b,), dtype=torch.bool, device=dev)
    probed = torch.zeros((b,), dtype=torch.int32, device=dev)
    reason = torch.full((b,), STOP_EXHAUSTED, dtype=torch.int32, device=dev)
    sentinel = torch.full((), n_tot, dtype=torch.int32, device=dev)

    for g in range(n_groups):
        # repro: allow[RPR001] host-driven group loop, one sync per group (ROADMAP Queue D item 8)
        if g and not bool(live.any()):  # repro: allow[RPR002] host group loop, ROADMAP Queue D item 8
            break
        lo = g * G
        tbl_g = tbl[lo : lo + G]
        block = _probe_one_table(state.sorted_keys[tbl_g], state.perm[tbl_g],
                                 kw[:, lo : lo + G].T.contiguous(), C)  # (G, b, C)
        block = block.permute(1, 0, 2).reshape(b, G * C)
        if segmented:
            block = _mask_dead(block, tombstones, n_main, n_tot)
        # stopped queries ride an all-sentinel block: their result is frozen
        block = torch.where(live[:, None], block, sentinel)
        heap_ids = torch.where(heap_i >= 0, heap_i, sentinel)
        cand, _ = _dedupe_candidates(torch.cat([heap_ids, block], dim=1), n_tot)
        nd, ni = ops.gather_rerank_topk(main_data, cand, queries, weights, k,
                                        scales=scales, delta=delta_data)
        heap_d = torch.where(live[:, None], nd, heap_d)
        heap_i = torch.where(live[:, None], ni, heap_i)
        n_cand = n_cand + mark_new(cand)
        probed = probed + live.to(torch.int32) * min(G, n_windows - lo)

        rk = heap_d[:, k - 1]
        heap_full = heap_i[:, k - 1] >= 0
        geo = heap_full & w_nonneg & (rk <= 0.0)
        if exit_slack > 0.0:
            rk_safe = torch.where(torch.isfinite(rk), rk, torch.zeros_like(rk))
            tables_done = torch.clamp(probed, max=L).to(torch.float32)
            log_miss = _miss_log_prob(rk_safe, weights, cfg, tables_done)
            conf = heap_full & (log_miss <= math.log(exit_slack))
        else:
            # slack 0 disables the confidence rule: an underflowed miss
            # estimate must never read as "certain"
            conf = torch.zeros_like(geo)
        reason = torch.where(live & geo, STOP_GEOMETRIC, reason)
        reason = torch.where(live & conf & ~geo, STOP_CONFIDENCE, reason)
        live = live & ~(geo | conf)

    return QueryResult(
        dists=heap_d,
        ids=heap_i,
        n_candidates=n_cand,
        tables_probed=probed,
        stop_reason=reason,
    )
