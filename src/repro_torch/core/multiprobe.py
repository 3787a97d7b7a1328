"""Query-directed MULTIPROBE for (d_w^l1, theta)-ALSH — counterpart of
``repro.core.multiprobe``.

Besides the query's own bucket, each table is probed at the buckets whose
keys flip the query code's lowest-margin bits (Lv et al., VLDB'07), in
increasing flip cost. Execution-wise multiprobe is only a different key
enumeration: :func:`multiprobe_keys_for` gives the (b, L, P) probing
sequence, and the engine runs the same sorted-window source and fused tail
as the single-probe path (which enumerates P = 1).
"""

from __future__ import annotations

import torch

from repro_torch.core import transforms
from repro_torch.core.families import get_family
from repro_torch.core.index import ALSHIndex, IndexConfig, QueryResult
from repro_torch.kernels import ops

# The probing defaults: QuerySpec's fields and the engine's keyword
# defaults both read these.
N_PROBES = 8
MAX_FLIPS = 3


def multiprobe_keys_for(
    index: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    n_probes: int,
    max_flips: int,
    with_ranks: bool = False,
):
    """The (b, L, P) query-directed probing sequence of a query batch: the
    query's own bucket key first, then perturbed keys in increasing
    flip-cost order. P is ``n_probes`` clamped to the family's reachable
    subset count.

    With ``with_ranks=True`` returns ``(keys, ranks)``, ``ranks`` the
    (b, L, P) int32 probe-quality rank — the P-axis position, since the
    family emits keys most-likely first (rank 0 is the own bucket)."""
    family = get_family(cfg.family)
    if not family.supports_multiprobe:
        raise ValueError(
            f"family {cfg.family!r} does not support multiprobe querying; "
            "build the index with family='theta' or query with "
            "QuerySpec(mode='probe')"
        )
    b = queries.shape[0]
    qlevels = transforms.discretize(queries, cfg.space)
    proj = ops.alsh_project(qlevels, index.tables.folded, weights,
                            tiled=index.tables.tiled)  # (b, H)
    keys = family.multiprobe_keys(proj.reshape(b, cfg.L, cfg.K), n_probes, max_flips)
    if not with_ranks:
        return keys
    ranks = torch.arange(keys.shape[2], dtype=torch.int32, device=keys.device)
    return keys, ranks[None, None, :].expand(keys.shape)


def query_multiprobe(
    index: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    k: int = 1,
    n_probes: int = N_PROBES,
    max_flips: int = MAX_FLIPS,
) -> QueryResult:
    """Multiprobe query: per table, probe the n_probes most likely buckets
    (query bucket + low-margin perturbations, ordered by the family's
    ``multiprobe_keys`` strategy). The reference's legacy entry;
    ``Index.query`` with ``QuerySpec(mode="multiprobe")`` runs the same
    engine call."""
    from repro_torch.engine import query

    return query(
        index, None, None, queries, weights, cfg,
        k=k, mode="multiprobe", n_probes=n_probes, max_flips=max_flips,
    )
