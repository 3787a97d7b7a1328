"""The row-sharded ALSH service — counterpart of ``repro.core.distributed``.

Sharding contract (the reference's), over a :class:`Mesh` of S devices:

  * database rows: disjointly partitioned, contiguously, over the mesh —
    shard s owns rows [s·n_local, (s+1)·n_local) and a complete local index
    over them (the (R1,R2)-NNS guarantee is closed under disjoint union:
    the global NN lives in exactly one shard);
  * hash tables and mixers: one set for every shard (the parent index's),
    so a query's keys are valid against every shard's sorted tables;
  * queries: replicated to every shard;
  * merge: each shard's exact top-k, then a top-k merge along each mesh
    axis, innermost first (or across the whole mesh at once).

One process drives every shard (the reference's single controller): the
per-shard state is a list, entry s on ``mesh.devices.flat[s]``, and each
shard's query is :func:`repro_torch.engine.dispatch` over its slice, as the
reference's ``shard_map`` body is. The reference's collectives become copies
of (b, k) tensors to the device of each merge group's first shard, which on
one card are no copies at all. A device may repeat in a mesh: that is how
several shards share one card, or the CPU.

The reference's ``local_index_specs``/``local_delta_specs`` (JAX
``PartitionSpec`` trees) have no counterpart here: the per-shard lists are
the layout.

``merge_topk_host`` is the serving tier's host-side merge of per-shard
answers (``serving.chaos.ShardSet``), in numpy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import engine
from repro_torch.core import hash_families as hf
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    build_index,
    delta_insert,
    draw_tables,
)


class Mesh:
    """A named grid of devices, the stand-in for ``jax.sharding.Mesh``.

    ``devices`` is a numpy object array of ``torch.device`` with the mesh's
    shape; shard s lives on ``devices.flat[s]`` (row-major over the axes,
    the reference's ``_shard_rank``). A device may appear more than once."""

    def __init__(self, devices, axis_names):
        devices = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or devices.size == 0:
            raise ValueError(
                f"a Mesh of shape {devices.shape} needs one name per axis; "
                f"got axis_names={axis_names}"
            )
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names must be distinct, got {axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(devices)
        self.axis_names = axis_names

    @property
    def shape(self) -> dict:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={sorted({str(d) for d in self.devices.flat})})"


def make_mesh(shape, axis_names, devices=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` (one size per name in ``axis_names``),
    the stand-in for ``jax.make_mesh``.

    ``devices=None`` takes every visible CUDA device, whose count must be
    the product of ``shape``; there is never a quiet switch to the CPU.
    Pass ``devices=`` to place shards yourself, repeating a device to put
    several shards on it: ``[torch.device("cuda", 0)] * 8`` runs eight
    shards on one card, ``[torch.device("cpu")] * 8`` on the CPU."""
    shape = tuple(int(s) for s in shape)
    size = math.prod(shape)
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count != size:
            raise ValueError(
                f"make_mesh({shape}) needs {size} devices and this host has {count} "
                f"CUDA device(s); pass devices= to place the shards, e.g. "
                f"devices=[torch.device('cuda', 0)] * {size} for {size} shards on one "
                f"card or [torch.device('cpu')] * {size} on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != size:
        raise ValueError(f"make_mesh({shape}) needs {size} devices, got {len(devices)}")
    if any(d.type == "cuda" for d in devices) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: a CUDA device was named and no CUDA device is available")
    return Mesh(np.array(devices, dtype=object).reshape(shape), axis_names)


class ShardedQueryResult(NamedTuple):
    dists: torch.Tensor  # (b, k) f32 global ascending
    ids: torch.Tensor  # (b, k) int32 global ids (-1 on sentinel slots)
    n_candidates: torch.Tensor  # (b,) int32 summed over shards


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


def make_sharded_delta(
    cfg: IndexConfig, mesh: Mesh, capacity: int, dtype, n_local: int
) -> tuple[list[DeltaSegment], list[torch.Tensor]]:
    """Empty per-shard delta segments of ``capacity`` slots each, and the
    per-shard tombstones ((n_local + capacity,) bool: main slots first, then
    delta slots), each on its shard's device."""
    deltas, tombstones = [], []
    for dev in mesh.devices.flat:
        deltas.append(DeltaSegment.empty(cfg, capacity, dtype=dtype, device=dev))
        tombstones.append(torch.zeros((n_local + capacity,), dtype=torch.bool, device=dev))
    return deltas, tombstones


def build_local_indexes(
    tables: hf.PrefixTables, mixers: torch.Tensor, data: torch.Tensor, cfg: IndexConfig,
    mesh: Mesh,
) -> list[ALSHIndex]:
    """Build one complete local index per shard, once: shard s indexes rows
    ``shard_row_ranges(n, S)[s]`` of ``data`` on ``mesh.devices.flat[s]``,
    with the given tables and mixers (moved once per distinct device), so a
    query's keys are valid against every shard."""
    ranges = shard_row_ranges(data.shape[0], mesh.size)
    on_device: dict = {}
    out = []
    for dev, (lo, hi) in zip(mesh.devices.flat, ranges):
        if dev not in on_device:
            on_device[dev] = (tables.to(dev), mixers.to(dev))
        t, m = on_device[dev]
        out.append(build_index(None, data[lo:hi].to(dev), cfg, tables=t, mixers=m))
    return out


def _local_query(state, delta, tombstones, q, w, cfg, spec) -> QueryResult:
    """One shard's query body: the engine dispatch the single-host facade
    runs, over this shard's slice, with only the spec's ``k``, ``mode``,
    ``n_probes``, ``max_flips`` and ``impl`` — as the reference's
    ``_local_query`` passes them, so the screen and early exit stay off."""
    dev = state.device
    q = q.to(device=dev, dtype=torch.float32).contiguous()
    w = w.to(device=dev, dtype=torch.float32).contiguous()
    return engine.dispatch(
        state, delta, tombstones, q, w, cfg, k=spec.k, mode=spec.mode,
        n_probes=spec.n_probes, max_flips=spec.max_flips, impl=spec.impl,
    )


def local_results(
    index_sharded: list[ALSHIndex],
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    spec,
    delta_sharded: list[DeltaSegment] | None = None,
    tombstones_sharded: list[torch.Tensor] | None = None,
) -> list[QueryResult]:
    """Every shard's own answer in its LOCAL ids (main row i -> i, delta
    slot t -> n_local + t), shard by shard in rank order."""
    out = []
    for s, state in enumerate(index_sharded):
        delta = None if delta_sharded is None else delta_sharded[s]
        ts = None if tombstones_sharded is None else tombstones_sharded[s]
        out.append(_local_query(state, delta, ts, queries, weights, cfg, spec))
    return out


def globalize_ids(ids: torch.Tensor, rank: int, n_shards: int, n_local: int) -> torch.Tensor:
    """Local ids of shard ``rank`` -> global ids: main row i is
    ``rank·n_local + i`` (contiguous partition); delta slot t is
    ``S·n_local + t·S + rank`` (inserts route round-robin, so the t-th slot
    of shard s held the (t·S + s)-th insert); -1 stays -1."""
    ids64 = ids.long()
    main_g = ids64 + rank * n_local
    delta_g = n_shards * n_local + (ids64 - n_local) * n_shards + rank
    gids = torch.where(ids64 < n_local, main_g, delta_g)
    return torch.where(ids64 < 0, torch.full_like(gids, -1), gids).to(torch.int32)


def _merge_group(parts, k: int):
    """Top-k merge of one group's (dists, ids, n_candidates) on the device
    of its first member: concatenate in group order, keep the k smallest by
    a stable sort (ties to the lower position, as ``lax.top_k(-d)``), sum
    the candidate counts."""
    dev = parts[0][0].device
    d = torch.cat([p[0].to(dev) for p in parts], dim=1)
    i = torch.cat([p[1].to(dev) for p in parts], dim=1)
    nc = torch.stack([p[2].to(dev) for p in parts]).sum(dim=0, dtype=torch.int32)
    order = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, order), torch.gather(i, 1, order), nc


def _globalize_and_merge(results, mesh: Mesh, k: int, n_local: int,
                         merge_hierarchical: bool) -> ShardedQueryResult:
    """Per-shard local results (rank order) -> one merged global answer on
    ``mesh.devices.flat[0]``: ids globalized, then merged along each axis,
    innermost first (each hop's groups are consecutive in row-major rank
    order), or across the whole mesh at once."""
    S = mesh.size
    parts = [(r.dists, globalize_ids(r.ids, s, S, n_local), r.n_candidates)
             for s, r in enumerate(results)]
    if merge_hierarchical:
        for g in reversed(mesh.devices.shape):  # e.g. model -> data -> pod
            parts = [_merge_group(parts[j:j + g], k) for j in range(0, len(parts), g)]
    else:  # flat merge across the whole mesh at once (baseline)
        parts = [_merge_group(parts, k)]
    d, i, nc = parts[0]
    return ShardedQueryResult(dists=d, ids=i, n_candidates=nc)


def sharded_index_query(
    index_sharded: list[ALSHIndex],
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    mesh: Mesh,
    spec=None,
    k: int = 10,
    merge_hierarchical: bool = True,
    delta_sharded: list[DeltaSegment] | None = None,
    tombstones_sharded: list[torch.Tensor] | None = None,
) -> ShardedQueryResult:
    """Query prebuilt shard-local indexes (from ``build_local_indexes``).

    ``spec`` (a :class:`repro_torch.api.QuerySpec`; default
    ``QuerySpec(k=k)``) selects each shard's mode — probe, multiprobe or
    exact. With ``delta_sharded``/``tombstones_sharded`` (a mutable
    ``ShardedIndex``) each shard also matches its private delta slice and
    masks its tombstones; merged ids follow ``globalize_ids``."""
    from repro_torch.api import QuerySpec  # lazy: api builds on core

    if spec is None:
        spec = QuerySpec(k=k)
    res = local_results(index_sharded, queries, weights, cfg, spec, delta_sharded,
                        tombstones_sharded)
    return _globalize_and_merge(res, mesh, spec.k, index_sharded[0].n, merge_hierarchical)


def sharded_delta_insert(
    index_sharded: list[ALSHIndex],
    delta_sharded: list[DeltaSegment],
    rows: torch.Tensor,
    cfg: IndexConfig,
    mesh: Mesh,
) -> tuple[list[DeltaSegment], torch.Tensor]:
    """Insert rows into the per-shard delta segments, routed by global id.

    Stream position e (e = the running insert count, resumed from the total
    fill: phase = ``sum(fill) % S``) goes to shard ``e % S``, slot ``e //
    S`` of its slice — round-robin striping, so every shard's delta fills
    evenly and the single-host id scheme holds. Each shard hashes its own
    rows with the shared tables. Returns (new per-shard deltas, (m,) int32
    global ids in stream order on ``mesh.devices.flat[0]``; -1 where the
    owning shard's delta was full)."""
    S = mesh.size
    n_local = index_sharded[0].n
    m = rows.shape[0]
    phase = sum(d.fill for d in delta_sharded) % S
    owner = (phase + torch.arange(m)) % S  # stream position j -> its shard
    ids = torch.full((m,), -1, dtype=torch.int32, device=mesh.devices.flat[0])
    out = []
    for s, (state, delta) in enumerate(zip(index_sharded, delta_sharded)):
        pos = torch.nonzero(owner == s).flatten()  # ascending: the shard's slot order
        if pos.numel() == 0:
            out.append(delta)
            continue
        dev = state.device
        rows_s = rows.to(dev)[pos.to(dev)].to(torch.float32).contiguous()
        new, local = delta_insert(state, delta, rows_s, cfg)  # local: n_local + slot, or -1
        gids = torch.where(local >= 0, S * n_local + (local.long() - n_local) * S + s,
                           torch.full_like(local, -1, dtype=torch.int64))
        ids[pos.to(ids.device)] = gids.to(device=ids.device, dtype=torch.int32)
        out.append(new)
    return out, ids


def sharded_tombstone(
    tombstones_sharded: list[torch.Tensor],
    gids,
    delta_fill: list[int],
    mesh: Mesh,
    n_local: int,
    cap: int,
) -> list[torch.Tensor]:
    """Tombstone global ids on their owning shards (the others drop them).

    The owner and local slot invert ``globalize_ids``: main gid g lives on
    shard ``g // n_local`` at slot ``g % n_local``; delta gid ``S·n_local +
    e`` on shard ``e % S`` at slot ``n_local + e // S``. Unknown gids —
    negative, out of range, or naming a delta slot at or past its owner's
    fill — are ignored, as single-host ``tombstone_ids`` ignores them."""
    S = mesh.size
    n_main = n_local * S
    g_all = torch.as_tensor(gids).reshape(-1).long()
    out = []
    for s, ts in enumerate(tombstones_sharded):
        g = g_all.to(ts.device)
        safe = torch.clamp(g, min=0)
        is_main = (g >= 0) & (g < n_main)
        e = safe - n_main
        in_delta = (g >= n_main) & (g < n_main + cap * S) & (e // S < delta_fill[s])
        owner = torch.where(is_main, safe // n_local, e % S)
        slot = torch.where(is_main, safe % n_local, n_local + e // S)
        mine = (is_main | in_delta) & (owner == s)
        # misses land on one spare slot past the end, dropped after
        new = torch.cat([ts, ts.new_zeros(1)])
        new[torch.where(mine, slot, torch.full_like(slot, n_local + cap))] = True
        out.append(new[: n_local + cap])
    return out


def sharded_query(
    generator: torch.Generator,
    data: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    mesh: Mesh,
    k: int = 10,
    merge_hierarchical: bool = True,
    spec=None,
) -> ShardedQueryResult:
    """One-shot build and query: the tables are drawn once from
    ``generator`` (a CPU generator: the draw ``Index.build`` makes from it)
    for every shard, then each shard builds over its rows and the answers
    merge. ``k`` is ignored when ``spec`` is given."""
    tables, mixers = draw_tables(generator, cfg)
    index_sharded = build_local_indexes(tables, mixers, torch.as_tensor(data), cfg, mesh)
    return sharded_index_query(index_sharded, queries, weights, cfg, mesh, spec=spec, k=k,
                               merge_hierarchical=merge_hierarchical)
