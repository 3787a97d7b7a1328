"""Host-side pieces of ``repro.core.distributed`` that the serving tier's
shard set uses: the contiguous row partition and the top-k merge of
per-shard answers, in numpy.

The mesh-collective sharded index of the reference module (one program
over many devices) is ROADMAP Queue A item 12 and is not ported here.
"""

from __future__ import annotations

import numpy as np


def shard_row_ranges(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Contiguous equal row partition [start, stop) per shard: shard s owns
    [s·n_local, (s+1)·n_local), so a shard's local id plus its start IS the
    global id. Requires ``n % n_shards == 0``."""
    if n_shards <= 0 or n % n_shards:
        raise ValueError(
            f"n={n} database rows cannot be split into {n_shards} equal "
            f"shards — the contiguous-partition id scheme (and the one-"
            f"compiled-program-per-bucket serving contract) needs n % "
            f"n_shards == 0"
        )
    n_local = n // n_shards
    return [(s * n_local, (s + 1) * n_local) for s in range(n_shards)]


def merge_topk_host(dists: np.ndarray, ids: np.ndarray, k: int):
    """Host-side top-k merge of per-shard results.

    Args:
      dists: (S, b, k') per-shard ascending distances. Sentinel slots
        (``+inf``, incl. ENTIRE dead-shard blocks — a killed shard
        contributes only sentinels) sink to the tail.
      ids: (S, b, k') matching global ids (``-1`` on sentinel slots).
      k: result width.

    Returns:
      (dists (b, k), ids (b, k)) numpy arrays, ascending per row; ids are
      ``-1`` wherever fewer than k finite candidates exist across the
      surviving shards. Deterministic (stable sort), so a recovered shard
      set answers bit-identically to the pre-failure one.
    """
    dists = np.asarray(dists)
    ids = np.asarray(ids)
    S, b, kk = dists.shape
    flat_d = np.moveaxis(dists, 0, 1).reshape(b, S * kk)
    flat_i = np.moveaxis(ids, 0, 1).reshape(b, S * kk)
    # sentinel ids must not win ties against real rows at equal distance
    order = np.argsort(
        np.where(flat_i < 0, np.inf, flat_d), axis=1, kind="stable"
    )[:, :k]
    out_d = np.take_along_axis(flat_d, order, axis=1)
    out_i = np.take_along_axis(flat_i, order, axis=1)
    out_d = np.where(out_i < 0, np.inf, out_d)
    return out_d, out_i
