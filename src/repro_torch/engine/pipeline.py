"""The execution pipeline: key enumeration → sources → one tail.

Counterpart of ``repro.engine.pipeline``:

  1. ``probe_keys`` — the (b, L, P) probing sequence: each table's own
     bucket key (mode "probe", P = 1) or the query-directed multiprobe
     sequence (mode "multiprobe");
  2. ``sources_for`` — the sealed sorted-table window source, plus the
     delta key match when the index has a delta segment; tombstones are
     masked inside the sources, before the merge;
  3. ``execute`` — merge the blocks, dedupe (unique ids packed
     first; the unique count is the paper's sublinearity metric), then,
     for a quantized table with ``screen_alpha`` > 0, a proxy screen over
     the encoded rows that keeps ``ceil(k·α)`` survivors, then the fused
     gather/rerank/top-k kernel over the decoded rows of BOTH segments
     (the two-segment kernels; no concatenated table).

``dispatch``/``query`` wire the stages for modes "probe" and "multiprobe".
Mode "exact" runs the streaming scan kernel over a sealed index (over the
decoded table for quantized storage) and, for a mutable index, the gather
tail over every live row (``ExhaustiveSource``). ``early_exit=True`` routes
the probe/multiprobe key lattice through :func:`execute_streamed` (the
streamed tail of :mod:`repro_torch.engine.stream`) instead of ``execute``;
``query`` folds it off exactly where the reference does, through
:func:`normalize_static_args`.
"""

from __future__ import annotations

import torch

from repro_torch import obs, quant
from repro_torch.core import transforms
from repro_torch.core.families import n_flip_subsets
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    _dedupe_candidates,
    _keys_for,
    delta_live_mask,
)
from repro_torch.core.multiprobe import MAX_FLIPS, N_PROBES, multiprobe_keys_for
from repro_torch.engine.sources import (
    CandidateSource,
    DeltaMatchSource,
    ExhaustiveSource,
    SortedTableSource,
)
from repro_torch.kernels import ops


def probe_keys(
    state: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
    impl: str = "auto",
) -> torch.Tensor:
    """The (b, L, P) probing sequence of a query batch: mode "probe" gives
    each query's own bucket key per table (P = 1), hashed with the ``impl``
    projection; mode "multiprobe" the query-directed perturbation sequence
    (P <= n_probes, clamped by the family's reachable-subset count)."""
    if mode == "multiprobe":
        return multiprobe_keys_for(state, queries, weights, cfg, n_probes, max_flips)
    if mode != "probe":
        raise ValueError(f"probe_keys: mode must be 'probe' or 'multiprobe', got {mode!r}")
    qlevels = transforms.discretize(queries, cfg.space)
    keys = _keys_for(qlevels, weights, state.tables, cfg, state.mixers, impl=impl)
    return keys[:, :, None]


def sources_for(
    state: ALSHIndex,
    delta: DeltaSegment | None,
    tombstones: torch.Tensor | None,
    cfg: IndexConfig,
    keys: torch.Tensor,
) -> list[CandidateSource]:
    """The candidate sources of one index view: the sealed table windows,
    plus the delta key match when a delta segment is present. One key
    enumeration feeds every source."""
    n_main = state.n
    cap = delta.capacity if delta is not None else 0
    n_tot = n_main + cap
    segmented = tombstones is not None or delta is not None
    if segmented and tombstones is None:
        tombstones = torch.zeros((n_tot,), dtype=torch.bool, device=state.device)
    srcs: list[CandidateSource] = [
        SortedTableSource(state, cfg, keys, tombstones=tombstones if segmented else None,
                          sentinel=n_tot)
    ]
    if cap:
        live = delta_live_mask(delta, tombstones, n_main)
        srcs.append(DeltaMatchSource(delta, keys, live, n_main, n_tot))
    return srcs


def execute(
    sources: list[CandidateSource],
    main_data: torch.Tensor,
    delta_data: torch.Tensor | None,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    n_valid: int,
    scales: torch.Tensor | None = None,
    screen_alpha: float = 0.0,
) -> QueryResult:
    """Merge source blocks → dedupe → [quantized screen →] fused
    gather/rerank/top-k over ``main_data`` (f32 or an encoded payload) and,
    when given, ``delta_data`` (the two-segment kernels).

    ``n_valid`` is the addressable row count (main plus delta capacity); an
    id >= n_valid is padding. A single ``pre_deduped`` source skips the
    dedupe and counts its valid entries. With ``screen_alpha`` > 0 the
    same fused kernel first ranks every candidate by the compressed-domain
    proxy distance (``quant.proxy_query``: no decode, the gather moves
    encoded bytes) and only the top ``ceil(k·α)`` survivors reach the exact
    rerank. The caller passes α = 0 for f32 storage and exact mode
    (``query`` folds it). Under a profiler the window probe, the dedupe, the
    proxy screen and the exact rerank are the stages ``probe``, ``dedupe``,
    ``screen`` (only when it runs) and ``gather`` (:mod:`repro_torch.obs`)."""
    dev = queries.device
    with obs.stage("probe", dev):
        blocks = [s.emit(queries, weights) for s in sources]
    cand = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    with obs.stage("dedupe", dev):
        if len(sources) == 1 and sources[0].pre_deduped:
            n_candidates = (cand < n_valid).sum(dim=1).to(torch.int32)
        else:
            cand, n_candidates = _dedupe_candidates(cand, n_valid)
    keep = quant.screen_keep(k, screen_alpha, cand.shape[1])
    if keep:
        with obs.stage("screen", dev):
            qp, wp = quant.proxy_query(queries, weights, main_data.dtype, scales)
            _, surv = ops.gather_rerank_topk(main_data, cand, qp, wp, keep, delta=delta_data)
            # survivors come back -1-padded; map them to the candidate sentinel
            # so invalid slots stay invalid (never row 0)
            cand = torch.where(surv >= 0, surv, torch.full_like(surv, n_valid))
    with obs.stage("gather", dev):
        dists, ids = ops.gather_rerank_topk(main_data, cand, queries, weights, k, scales=scales,
                                            delta=delta_data)
    return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)


def execute_streamed(
    state: ALSHIndex,
    delta: DeltaSegment | None,
    tombstones: torch.Tensor | None,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    keys: torch.Tensor,
    k: int,
    exit_group: int = 8,
    exit_slack: float = 0.0,
) -> QueryResult:
    """The adaptive-probing tail: stream the (b, L, P) window lattice in
    ``exit_group``-sized groups (quality-major order), carrying the running
    top-k heap and a per-query live mask, and stop each query as soon as the
    geometric bound or the Eq 25/27 confidence estimate (at ``exit_slack``
    miss budget) says the remaining windows cannot change its answer. See
    :mod:`repro_torch.engine.stream`; results also carry ``tables_probed``
    and ``stop_reason``."""
    from repro_torch.engine import stream

    return stream.stream_topk(state, delta, tombstones, queries, weights, cfg, keys, k,
                              scales=state.scales, exit_group=exit_group,
                              exit_slack=exit_slack)


def dispatch(
    state: ALSHIndex,
    delta: DeltaSegment | None,
    tombstones: torch.Tensor | None,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
    screen_alpha: float = 0.0,
    early_exit: bool = False,
    exit_group: int = 8,
    exit_slack: float = 0.0,
    impl: str = "auto",
) -> QueryResult:
    """One query over one index view: ``mode`` "probe", "multiprobe" (ALSH)
    or "exact". ``delta``/``tombstones`` are None for a sealed index; then
    exact mode is the streaming scan over the decoded table (``cfg`` may be
    None), and otherwise the gather tail over every live row of both
    segments. ``early_exit=True`` sends the ALSH key lattice through
    :func:`execute_streamed` instead of ``execute`` (``query`` folds it off
    where streaming cannot apply). Runs on ``state``'s device; under a
    profiler key enumeration is the stage ``keys`` and the sealed exact scan
    the stage ``scan`` (:mod:`repro_torch.obs`)."""
    n_main = state.n
    cap = delta.capacity if delta is not None else 0
    segmented = tombstones is not None or delta is not None
    delta_data = delta.data if cap else None
    if mode == "exact":
        if not segmented:
            table = quant.decode_table(state.data, state.scales)  # f32: the same tensor
            with obs.stage("scan", queries.device):
                dists, ids = ops.wl1_scan_topk(table, queries, weights, k)
            n_candidates = torch.full((queries.shape[0],), n_main, dtype=torch.int32,
                                      device=queries.device)
            return QueryResult(dists=dists, ids=ids, n_candidates=n_candidates)
        if tombstones is None:
            tombstones = torch.zeros((n_main + cap,), dtype=torch.bool, device=state.device)
        src = ExhaustiveSource(state, delta, tombstones)
        return execute([src], state.data, delta_data, queries, weights, k,
                       n_valid=n_main + cap, scales=state.scales)
    with obs.stage("keys", queries.device):
        keys = probe_keys(state, queries, weights, cfg, mode=mode, n_probes=n_probes,
                          max_flips=max_flips, impl=impl)
    if early_exit:
        return execute_streamed(state, delta, tombstones, queries, weights, cfg, keys, k,
                                exit_group=exit_group, exit_slack=exit_slack)
    srcs = sources_for(state, delta, tombstones, cfg, keys)
    return execute(srcs, state.data, delta_data, queries, weights, k, n_valid=n_main + cap,
                   scales=state.scales, screen_alpha=screen_alpha)


def normalize_static_args(
    cfg: IndexConfig | None,
    storage_dtype: torch.dtype,
    k: int,
    mode: str,
    n_probes: int,
    max_flips: int,
    impl: str,
    screen_alpha: float,
    early_exit: bool = False,
    exit_group: int = 8,
    exit_slack: float = 0.0,
) -> tuple:
    """Canonicalize the static arguments of a query: every static a mode
    does not read is forced to its neutral value, so two calls that run the
    same program always present the same key — counterpart of the
    reference's function of the same name, fold for fold. ``query`` applies
    it on every call, and :mod:`repro_torch.analysis.audit` counts the
    entry-point lattice's distinct programs through it (a CUDA graph
    captured per program would key on exactly that count).

    Folds: ``n_probes``/``max_flips`` outside multiprobe, ``impl`` outside
    probe, ``cfg`` for exact mode, ``screen_alpha`` for exact mode and f32
    storage (``storage_dtype`` is the table's torch dtype). Early exit folds
    off for exact mode (the scan visits every row once), under an active
    quantized screen (a global candidate-set stage) and when one group
    covers the whole L·P window lattice (that group IS the monolithic tail);
    whenever it is off, ``exit_group``/``exit_slack`` are 0.

    Returns the normalized ``(cfg, k, mode, n_probes, max_flips, impl,
    screen_alpha, early_exit, exit_group, exit_slack)`` tuple.
    """
    if mode != "multiprobe":
        n_probes, max_flips = 1, 0
    if mode != "probe":
        impl = "auto"
    if mode == "exact":
        cfg = None
    if mode == "exact" or storage_dtype == torch.float32:
        screen_alpha = 0.0
    if early_exit:
        if mode == "exact" or screen_alpha > 0.0:
            early_exit = False
        else:
            p_eff = 1 if mode == "probe" else min(n_probes, n_flip_subsets(cfg.K, max_flips))
            if exit_group >= cfg.L * p_eff:
                early_exit = False  # one group == the monolithic tail
    if not early_exit:
        exit_group, exit_slack = 0, 0.0
    return (cfg, k, mode, n_probes, max_flips, impl, float(screen_alpha), bool(early_exit),
            int(exit_group), float(exit_slack))


def query(
    state: ALSHIndex,
    delta: DeltaSegment | None,
    tombstones: torch.Tensor | None,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig | None,
    k: int = 1,
    mode: str = "probe",
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
    screen_alpha: float = 0.0,
    early_exit: bool = False,
    exit_group: int = 8,
    exit_slack: float = 0.0,
    impl: str = "auto",
) -> QueryResult:
    """The engine entry every consumer shares (the reference's arguments;
    ``impl`` last). Queries move to the index's device as contiguous f32.
    ``impl`` picks the probe mode's query projection (see
    ``hash_families.project_query``); the other modes ignore it, as the
    reference's normalization does.

    The static arguments are folded by :func:`normalize_static_args` first,
    as the reference folds them before its compile-key lookup: the folds
    decide which tail runs, and the audit
    (:mod:`repro_torch.analysis.audit`) counts the distinct programs
    through the same function."""
    (cfg, k, mode, n_probes, max_flips, impl, screen_alpha, early_exit, exit_group,
     exit_slack) = normalize_static_args(cfg, state.data.dtype, k, mode, n_probes, max_flips,
                                         impl, screen_alpha, early_exit, exit_group, exit_slack)
    dev = state.device
    queries = queries.to(device=dev, dtype=torch.float32).contiguous()
    weights = weights.to(device=dev, dtype=torch.float32).contiguous()
    return dispatch(state, delta, tombstones, queries, weights, cfg, k=k, mode=mode,
                    n_probes=n_probes, max_flips=max_flips, screen_alpha=screen_alpha,
                    early_exit=early_exit, exit_group=exit_group, exit_slack=exit_slack,
                    impl=impl)
