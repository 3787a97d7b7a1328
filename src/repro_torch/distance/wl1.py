"""Reference generalized weighted distances (paper Eq. 2).

Counterpart of ``repro.distance.wl1``:
``d_w^l1(o, q) = sum_i w_i |o_i - q_i|`` and
``d_w^l2(o, q) = sum_i w_i (o_i - q_i)^2`` (weights arrive with the query
and may be negative). ``brute_force_nn`` is the exact O(nd) baseline: wl1
through the streaming scan kernel, wl2 (the comparison baseline) by a
direct reduction.
"""

from __future__ import annotations

import numpy as np
import torch


def wl1_distance(o: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Generalized weighted Manhattan distance over the last axis (broadcasting)."""
    return torch.sum(w * (o - q).abs(), dim=-1)


def wl2_distance(o: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Generalized weighted square Euclidean distance (comparison baseline)."""
    diff = o - q
    return torch.sum(w * diff * diff, dim=-1)


def pairwise_wl1(O: torch.Tensor, Q: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """All pairs: ``O (n, d)``, ``Q (b, d)``, ``W (b, d)`` -> ``(b, n)`` (materializing)."""
    return torch.sum(W[:, None, :] * (O[None, :, :] - Q[:, None, :]).abs(), dim=-1)


def recall_at_k(ids, ref_ids, k: int | None = None) -> float:
    """Mean recall@k of retrieved ``ids`` against reference ``ref_ids``;
    entries < 0 are padding and never count; ``k`` defaults to
    ``ref_ids.shape[1]``."""
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    ref = ref_ids.cpu().numpy() if isinstance(ref_ids, torch.Tensor) else np.asarray(ref_ids)
    if k is None:
        k = ref.shape[1]
    hits = [
        len({x for x in ids[i].tolist() if x >= 0} & {x for x in ref[i].tolist() if x >= 0}) / k
        for i in range(ids.shape[0])
    ]
    return float(np.mean(hits))


def brute_force_nn(
    data: torch.Tensor, q: torch.Tensor, w: torch.Tensor, k: int = 1, distance: str = "wl1"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN by linear scan under ``distance`` "wl1" (``ops.wl1_scan_topk``)
    or "wl2" (a direct reduction, ``CHUNK_ELEMS`` values at a time).

    ``q``/``w`` are ``(d,)`` or ``(b, d)``; returns ascending ``(dists,
    ids)`` of shape ``(k,)`` or ``(b, k)``; equal distances go to the lower
    id, as ``lax.top_k`` orders them.
    """
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import CHUNK_ELEMS

    if distance not in ("wl1", "wl2"):
        raise ValueError(f"brute_force_nn: distance must be 'wl1' or 'wl2', got {distance!r}")
    squeeze = q.ndim == 1
    qb = torch.atleast_2d(q).contiguous()
    wb = torch.atleast_2d(w).contiguous()
    if distance == "wl1":
        dists, ids = ops.wl1_scan_topk(data, qb, wb, k)
    else:
        n, d = data.shape
        step = max(1, CHUNK_ELEMS // max(1, n * d))
        dist = torch.cat([wl2_distance(data[None], qb[s:s + step, None], wb[s:s + step, None])
                          for s in range(0, qb.shape[0], step)])  # (b, n)
        order = torch.argsort(dist, dim=1, stable=True)[:, :k]  # ties to the lower id
        dists, ids = torch.gather(dist, 1, order), order.to(torch.int32)
    if squeeze:
        return dists[0], ids[0]
    return dists, ids
