"""Reference generalized weighted distances (paper Eq. 2).

Counterpart of ``repro.distance.wl1``:
``d_w^l1(o, q) = sum_i w_i |o_i - q_i|`` (weights arrive with the query and
may be negative). ``brute_force_nn`` is the exact O(nd) baseline, through
the streaming scan kernel.
"""

from __future__ import annotations

import numpy as np
import torch


def wl1_distance(o: torch.Tensor, q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Generalized weighted Manhattan distance over the last axis (broadcasting)."""
    return torch.sum(w * (o - q).abs(), dim=-1)


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
    data: torch.Tensor, q: torch.Tensor, w: torch.Tensor, k: int = 1
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN under d_w^l1 by linear scan (``ops.wl1_scan_topk``).

    ``q``/``w`` are ``(d,)`` or ``(b, d)``; returns ascending ``(dists,
    ids)`` of shape ``(k,)`` or ``(b, k)``.
    """
    from repro_torch.kernels import ops

    squeeze = q.ndim == 1
    qb = torch.atleast_2d(q).contiguous()
    wb = torch.atleast_2d(w).contiguous()
    dists, ids = ops.wl1_scan_topk(data, qb, wb, k)
    if squeeze:
        return dists[0], ids[0]
    return dists, ids
