"""Plain PyTorch versions of the CUDA kernels of the port.

Counterpart of ``repro.kernels.ref`` (and of the chunked jnp schedules). The
CPU path of :mod:`repro_torch.kernels.ops` runs these, the tests hold them
against the JAX package, and the CUDA tests hold each CUDA kernel against
them on the card.

Every function here CHUNKS its work: the reference oracles materialize
(n, H, d) or (b, n, d) intermediates, which at the service width are tens of
GB. Chunks are sized to keep one intermediate near ``CHUNK_ELEMS`` values.

Top-k selection is a stable sort over position-ordered candidates, so ties
go to the earlier candidate — for id-ascending candidates, the lower id
(what ``lax.top_k`` gives; ``torch.topk`` promises nothing about ties).
"""

from __future__ import annotations

import torch

CHUNK_ELEMS = 1 << 24  # values per materialized intermediate (64 MB of f32)


def alsh_project(
    levels: torch.Tensor, folded: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """§4.2.3 projection: proj[n, h] = sum_i w[n, i] * folded[h, i, levels[n, i]].

    levels (n, d) int32 in {0..M}, folded (H, d, M+1) f32, weights (n, d) f32
    or None (the data side) -> (n, H) f32.
    """
    n, d = levels.shape
    H = folded.shape[0]
    out = torch.empty((n, H), dtype=folded.dtype, device=folded.device)
    coord = torch.arange(d, device=levels.device)[None, :]
    step = max(1, CHUNK_ELEMS // max(1, H * d))
    for s in range(0, n, step):
        lv = levels[s : s + step].long()
        picked = folded[:, coord, lv]  # (H, chunk, d)
        if weights is not None:
            picked = picked * weights[s : s + step][None].to(picked.dtype)
        out[s : s + step] = picked.sum(dim=-1).T
    return out


def wl1_scan(data: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Brute-force weighted-Manhattan scan, materializing: data (n, d),
    queries/weights (b, d) -> (b, n) f32, ``sum_i w_i |x_i - q_i|``. Weights
    may be negative. Chunked over rows (the (b, n, d) intermediate of the
    reference oracle is 8.6 GB at n=262,144, b=64, d=128)."""
    n, d = data.shape
    b = queries.shape[0]
    q = queries.float()
    w = weights.float()
    out = torch.empty((b, n), dtype=torch.float32, device=data.device)
    step = max(1, CHUNK_ELEMS // max(1, b * d))
    for s in range(0, n, step):
        rows = data[s : s + step].float()
        out[:, s : s + step] = (w[:, None, :] * (rows[None, :, :] - q[:, None, :]).abs()).sum(-1)
    return out


def wl1_rerank(pts: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Candidate re-rank: pts (b, C, d), queries/weights (b, d) -> (b, C) f32,
    ``sum_i w_i |p_i - q_i|`` per candidate. Chunked over candidates."""
    b, C, d = pts.shape
    q = queries.float()[:, None, :]
    w = weights.float()[:, None, :]
    out = torch.empty((b, C), dtype=torch.float32, device=pts.device)
    step = max(1, CHUNK_ELEMS // max(1, b * d))
    for s in range(0, C, step):
        out[:, s : s + step] = (w * (pts[:, s : s + step].float() - q).abs()).sum(-1)
    return out


def _merge_topk(
    top_d: torch.Tensor, top_i: torch.Tensor, blk_d: torch.Tensor, blk_i: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """k smallest of [running top ‖ block], stable: earlier entries win ties."""
    k = top_d.shape[1]
    cand_d = torch.cat([top_d, blk_d], dim=1)
    cand_i = torch.cat([top_i, blk_i], dim=1)
    sd, order = torch.sort(cand_d, dim=1, stable=True)
    return sd[:, :k], torch.gather(cand_i, 1, order[:, :k])


def _init_topk(b: int, k: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    return (
        torch.full((b, k), float("inf"), dtype=torch.float32, device=device),
        torch.full((b, k), -1, dtype=torch.int32, device=device),
    )


def _finish(top_d: torch.Tensor, top_i: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    # invalid-slot contract (QueryResult): ids == -1 ⇔ dists == +inf
    return top_d, torch.where(torch.isfinite(top_d), top_i, torch.full_like(top_i, -1))


def wl1_scan_topk(
    data: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by a streaming scan over row chunks.

    data (n, d), queries/weights (b, d) -> ((b, k) ascending dists, (b, k)
    ids), (+inf, -1) where fewer than k rows exist. Ties go to the lower id.
    """
    n, d = data.shape
    b = queries.shape[0]
    q = queries.float()
    w = weights.float()
    top_d, top_i = _init_topk(b, k, data.device)
    step = max(1, CHUNK_ELEMS // max(1, b * d))
    for s in range(0, n, step):
        rows = data[s : s + step].float()
        dists = (w[:, None, :] * (rows[None, :, :] - q[:, None, :]).abs()).sum(dim=-1)
        ids = torch.arange(s, s + rows.shape[0], dtype=torch.int32, device=data.device)
        top_d, top_i = _merge_topk(top_d, top_i, dists, ids[None, :].expand(b, -1))
    return _finish(top_d, top_i)


def gather_rerank_topk(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused candidate tail: gather + exact d_w^l1 re-rank + top-k.

    data (n, d) f32, or a quantized payload (bf16/int8, see
    ``repro_torch.quant``); ids (b, P) int32 candidate ids, entries >= n
    (or < 0) are invalid; queries/weights (b, d); scales (d,) f32 or None
    -> ((b, k) ascending dists, (b, k) ids; (+inf, -1) where invalid).
    Ties go to the earlier candidate slot.

    The ENCODED rows are gathered chunk by chunk and each gathered chunk is
    decoded (widen to f32, then ``* scales`` when given); the stored table
    is never decoded whole.
    """
    n, d = data.shape
    b, P = ids.shape
    q = queries.float()
    w = weights.float()
    top_d, top_i = _init_topk(b, k, data.device)
    step = max(1, CHUNK_ELEMS // max(1, b * d))
    for s in range(0, P, step):
        cid = ids[:, s : s + step]
        valid = (cid >= 0) & (cid < n)
        rows = data[cid.clamp(0, max(n - 1, 0)).long()].float()  # (b, chunk, d)
        if scales is not None:
            rows = rows * scales
        dists = (w[:, None, :] * (rows - q[:, None, :]).abs()).sum(dim=-1)
        dists = torch.where(valid, dists, torch.full_like(dists, float("inf")))
        blk_i = torch.where(valid, cid, torch.full_like(cid, -1)).to(torch.int32)
        top_d, top_i = _merge_topk(top_d, top_i, dists, blk_i)
    return _finish(top_d, top_i)


def gather_rerank_topk_segmented(
    data: torch.Tensor,
    delta: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-segment candidate tail over the virtual ``[data; delta]`` table,
    never concatenated: id < n_main is a main row, id in [n_main, n_main +
    cap) is delta slot id − n_main, ids >= n_main + cap and ids < 0 are
    invalid. Delta rows are cast through the main table's dtype and decoded
    with the same ``scales`` (delta rows are encoded with the sealed
    segment's scales). The plain version of both two-segment kernels; it
    returns what ``gather_rerank_topk`` returns over ``cat([data, delta])``.
    """
    n_main, d = data.shape
    cap = delta.shape[0]
    n_tot = n_main + cap
    b, P = ids.shape
    delta = delta.to(data.dtype)
    # a segment with no rows still needs one readable row for the clamped gather
    main_t = data if n_main else data.new_zeros((1, d))
    delta_t = delta if cap else data.new_zeros((1, d))
    q = queries.float()
    w = weights.float()
    top_d, top_i = _init_topk(b, k, data.device)
    step = max(1, CHUNK_ELEMS // max(1, b * d))
    for s in range(0, P, step):
        cid = ids[:, s : s + step]
        valid = (cid >= 0) & (cid < n_tot)
        in_main = (cid < n_main)[..., None]
        rows_m = main_t[cid.clamp(0, max(n_main - 1, 0)).long()]
        rows_d = delta_t[(cid - n_main).clamp(0, max(cap - 1, 0)).long()]
        rows = torch.where(in_main, rows_m, rows_d).float()  # (b, chunk, d)
        del rows_m, rows_d  # at most three (b, chunk, d) blocks live at once
        if scales is not None:
            rows = rows * scales
        dists = (rows - q[:, None, :]).abs_().mul_(w[:, None, :]).sum(dim=-1)
        dists = torch.where(valid, dists, torch.full_like(dists, float("inf")))
        blk_i = torch.where(valid, cid, torch.full_like(cid, -1)).to(torch.int32)
        top_d, top_i = _merge_topk(top_d, top_i, dists, blk_i)
    return _finish(top_d, top_i)


def multiprobe_keys(proj_lk: torch.Tensor, n_probes: int, max_flips: int) -> torch.Tensor:
    """Query-directed probing (Lv et al., VLDB'07): probe the buckets
    whose keys flip the lowest-|margin| bits of the query's code, in
    increasing total flipped margin. Ties go to the earlier subset in
    ``flip_subsets`` order (a stable sort, as ``lax.top_k`` breaks them).

    (b, L, K) raw projections -> (b, L, P) int32 keys, P = ``n_probes``
    clamped to the subset count. The subset table is built on the host at
    every call (imported here: ``repro_torch.core`` imports this module)."""
    from repro_torch.core.families import flip_subsets

    K = proj_lk.shape[-1]
    dev = proj_lk.device
    masks = flip_subsets(K, max_flips, device=dev)  # (S, K)
    # score of a subset = total margin flipped (lower = more likely)
    scores = torch.einsum("blk,sk->bls", proj_lk.abs(), masks.to(proj_lk.dtype))
    n_probes = min(n_probes, masks.shape[0])
    probe_idx = torch.sort(scores, dim=-1, stable=True).indices[..., :n_probes]  # (b, L, P)
    shifts = torch.ones((), dtype=torch.int64, device=dev) << torch.arange(
        K, dtype=torch.int64, device=dev
    )
    base_key = torch.sum((proj_lk >= 0).to(torch.int64) * shifts, dim=-1)  # (b, L)
    flip_key = torch.sum(masks.to(torch.int64) * shifts, dim=-1)  # (S,) xor masks
    return torch.bitwise_xor(base_key[..., None], flip_key[probe_idx]).to(torch.int32)


def dedupe_candidates(cand: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort candidate ids, zap duplicates/invalids to the sentinel ``n`` and
    pack the unique ids first: (b, P) -> ((b, P) int32, (b,) int32 counts)."""
    cand = torch.sort(torch.clamp(cand, max=n), dim=1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    valid = (cand < n) & first
    packed = torch.sort(torch.where(valid, cand, torch.full_like(cand, n)), dim=1).values
    return packed.to(torch.int32), valid.sum(dim=1).to(torch.int32)


def unexplained_id_mismatches(
    got_i: torch.Tensor,
    want_d: torch.Tensor,
    want_i: torch.Tensor,
    data: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    rtol: float,
    atol: float,
) -> int:
    """Top-k slots whose ids differ between two versions of a kernel and
    that no genuine tie explains.

    Two versions that sum in different orders may order candidates whose
    distances agree within rounding either way. A mismatched slot is
    explained only when the id returned there is a real row whose distance
    to the query, recomputed here in f64 from ``data``, lies within ``atol +
    rtol * |d|`` of the reference distance at that slot. A right distance
    written beside a wrong id is not explained, and neither is an id
    repeated more often in a row than the reference repeats it (candidate
    lists that are not deduped may hold an id twice in both versions).
    """
    wd = want_d.double()
    n = data.shape[0]
    valid = (got_i >= 0) & (got_i < n)
    rows = data[got_i.long().clamp(0, max(n - 1, 0))].double()  # (b, k, d)
    true_d = (weights.double()[:, None, :] * (rows - queries.double()[:, None, :]).abs()).sum(-1)
    true_d = torch.where(valid, true_d, torch.full_like(true_d, float("inf")))
    tie = valid & ((true_d - wd).abs() <= atol + rtol * wd.abs())
    mism = got_i != want_i

    def repeats(ids: torch.Tensor) -> torch.Tensor:
        srt = torch.sort(ids, dim=1).values
        return ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(dim=1)

    extra = (repeats(got_i) - repeats(want_i)).clamp(min=0)
    return int((mism & ~tie).sum()) + int(extra.sum())  # repro: allow[RPR002] test/check helper, never on the query path
