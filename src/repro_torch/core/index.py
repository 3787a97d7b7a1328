"""The sealed ALSH index — counterpart of ``repro.core.index``.

Each of the L tables is a sorted key column:

  build:  codes (n, K) --combine--> keys (n,) --stable argsort--> (sorted_keys, perm)
  query:  key --searchsorted--> [start, end) --bounded window--> candidate ids

This module owns the data structures (``IndexConfig``, ``ALSHIndex``,
``DeltaSegment``, ``build_index``), the probe primitives
(``_probe_one_table``, ``_dedupe_candidates``, ``table_window_sizes``,
``query_keys_for``) and
the mutable lifecycle's primitives (``hash_rows``, ``delta_insert``,
``tombstone_ids``, the chunked delta key match ``_delta_candidates``,
``_mask_dead``, ``delta_live_mask``); query execution lives in
:mod:`repro_torch.engine`. Both segments are ported with every storage codec
(f32, bf16, int8; ``repro_torch.quant``).

``index_from_numpy`` and ``delta_from_numpy`` carry an index the JAX package
built (its ``ALSHIndex`` leaves, and a mutable index's delta leaves and
tombstones, as numpy arrays) into this package, which is how the parity
tests hold both packages to the same random tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hash_families as hf
from repro_torch.core import transforms
from repro_torch.core.families import HashFamily, get_family
from repro_torch.kernels import ops
from repro_torch.quant.codecs import STORAGE_KINDS, get_codec, storage_dtype

INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Static geometry of an ALSH index (same fields and validation as the
    reference). ``storage`` names the row codec of the table payload."""

    d: int
    M: int
    K: int  # hashes per table
    L: int  # tables
    family: str = "theta"  # "theta" | "l2"
    W: float = 4.0
    max_candidates: int = 64  # per-table probe budget C
    space: transforms.BoundedSpace = transforms.BoundedSpace(0.0, 1.0, 32.0)
    storage: str = "f32"

    def __post_init__(self):
        if isinstance(self.family, HashFamily):
            object.__setattr__(self, "family", self.family.name)
        for field in ("d", "M", "K", "L", "max_candidates"):
            v = getattr(self, field)
            if not isinstance(v, int) or v <= 0:
                raise ValueError(f"IndexConfig.{field} must be a positive int, got {v!r}")
        if self.storage not in STORAGE_KINDS:
            raise ValueError(
                f"IndexConfig.storage must be one of {STORAGE_KINDS}, got {self.storage!r}"
            )
        if self.space.M > self.M:
            raise ValueError(
                f"IndexConfig.space discretizes to {self.space.M} levels but "
                f"IndexConfig.M={self.M} — lattice points would index past the "
                f"hash tables; use space=BoundedSpace(lo, hi, t) with "
                f"(hi-lo)*t <= M"
            )
        get_family(self.family).validate(self)

    @property
    def n_hashes(self) -> int:
        return self.K * self.L

    @property
    def lsh_params(self) -> hf.LSHParams:
        return hf.LSHParams(d=self.d, M=self.M, n_hashes=self.n_hashes, family=self.family, W=self.W)


@dataclasses.dataclass
class ALSHIndex:
    """Built index state; every tensor lives on one device."""

    tables: hf.PrefixTables  # folded projection tables (H, d, M+1)
    mixers: torch.Tensor  # (L, K) int32 key combiners
    sorted_keys: torch.Tensor  # (L, n) int32 per-table sorted bucket keys
    perm: torch.Tensor  # (L, n + C) int32 point ids by key order, padded with n
    data: torch.Tensor  # (n, d) ENCODED rows in the cfg.storage dtype
    levels: torch.Tensor  # (n, d) int32 lattice points
    scales: torch.Tensor | None = None  # (d,) f32 decode scales (int8 storage only)

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "ALSHIndex":
        return ALSHIndex(
            tables=self.tables.to(device),
            mixers=self.mixers.to(device),
            sorted_keys=self.sorted_keys.to(device),
            perm=self.perm.to(device),
            data=self.data.to(device),
            levels=self.levels.to(device),
            scales=None if self.scales is None else self.scales.to(device),
        )


class QueryResult(NamedTuple):
    """Batched k-NN result. A slot is invalid iff ``ids == -1`` iff
    ``dists == +inf``; internal candidate sentinels never escape.

    ``tables_probed``/``stop_reason`` are set only by the streamed
    early-exit tail (None on the monolithic paths). Stop-reason codes: 0 =
    exhausted every group, 1 = geometric stop, 2 = confidence stop."""

    dists: torch.Tensor  # (b, k) ascending d_w^l1
    ids: torch.Tensor  # (b, k) int32 point ids
    n_candidates: torch.Tensor  # (b,) int32 unique candidates examined
    tables_probed: torch.Tensor | None = None  # (b,) int32 probe windows visited (streamed)
    stop_reason: torch.Tensor | None = None  # (b,) int32 stop code (streamed)


@dataclasses.dataclass
class DeltaSegment:
    """Fixed-capacity unsealed segment: rows inserted after the main build.

    Rows are hashed at insert time with the main segment's tables and
    mixers, so a query's per-table keys are valid against both segments.
    The delta is never sorted: it is probed by a chunked key match over its
    filled slots. Slots are append-only: deletes tombstone, only a compaction
    reclaims space.

    ``fill`` is a host ``int``. The reference keeps it as a device scalar so
    that ``jit`` does not retrace as it moves; this port has no jit, and a
    host int spares a device sync on every insert and lets the key match
    skip the unfilled blocks.
    """

    data: torch.Tensor  # (cap, d) ENCODED inserted rows in the main segment's dtype
    levels: torch.Tensor  # (cap, d) int32 lattice points of the inserted rows
    keys: torch.Tensor  # (L, cap) int32 per-table bucket keys of the inserted rows
    fill: int = 0  # slots used (append-only)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @classmethod
    def empty(cls, cfg: IndexConfig, capacity: int, dtype=torch.float32,
              device=None) -> "DeltaSegment":
        return cls(
            data=torch.zeros((capacity, cfg.d), dtype=dtype, device=device),
            levels=torch.zeros((capacity, cfg.d), dtype=torch.int32, device=device),
            keys=torch.zeros((cfg.L, capacity), dtype=torch.int32, device=device),
            fill=0,
        )

    def to(self, device) -> "DeltaSegment":
        return DeltaSegment(self.data.to(device), self.levels.to(device), self.keys.to(device),
                            self.fill)


def _keys_for(
    levels: torch.Tensor,
    weights: torch.Tensor | None,
    tables: hf.PrefixTables,
    cfg: IndexConfig,
    mixers: torch.Tensor,
    impl: str = "auto",
) -> torch.Tensor:
    """Hash points/queries to per-table keys: (b, d)[, (b, d) w] -> (b, L)
    int32; ``impl`` picks the query projection (``hf.project_query``)."""
    params = cfg.lsh_params
    if weights is None:
        codes = hf.hash_data(levels, tables, params)
    else:
        codes = hf.hash_query(levels, weights, tables, params, impl=impl)
    codes = codes.reshape(*codes.shape[:-1], cfg.L, cfg.K)
    return get_family(cfg.family).combine_codes(codes, mixers, cfg.K)


def draw_tables(generator: torch.Generator, cfg: IndexConfig) -> tuple[hf.PrefixTables,
                                                                       torch.Tensor]:
    """The hash tables and key mixers of one index, drawn from ``generator``
    (on its device: a CPU generator gives the same draw for every device)."""
    tables = hf.make_prefix_tables(generator, cfg.lsh_params)
    # odd int32 multipliers in [1, 2**31 - 1) (the l2 family's key mixing)
    mixers = torch.randint(1, INT32_MAX, (cfg.L, cfg.K), generator=generator, dtype=torch.int64)
    return tables, (mixers | 1).to(torch.int32)


def build_index(
    generator: torch.Generator | None,
    data: torch.Tensor,
    cfg: IndexConfig,
    tables: hf.PrefixTables | None = None,
    mixers: torch.Tensor | None = None,
) -> ALSHIndex:
    """Hash every row and sort each table by key, on ``data``'s device.

    Hashing and discretization see the RAW rows; the payload is encoded with
    the ``cfg.storage`` codec as the LAST step, so candidate generation is
    identical across codecs and only the rerank tail sees the compression.
    The tables and mixers are drawn from ``generator`` (a CPU generator
    gives the same state on every device) unless pre-drawn ``tables`` and
    ``mixers`` are passed, as the parity tests do with the reference's.
    """
    dev = data.device
    data = data.to(torch.float32).contiguous()
    if tables is None or mixers is None:
        if generator is None:
            raise ValueError("build_index needs a generator or pre-drawn tables and mixers")
        tables, mixers = draw_tables(generator, cfg)
    tables = tables.to(dev)
    mixers = mixers.to(dev)
    levels = transforms.discretize(data, cfg.space)
    keys_ln = _keys_for(levels, None, tables, cfg, mixers).T.contiguous()  # (L, n)
    # stable: a C-wide window truncates inside a bucket, so the order of
    # equal keys decides which rows are candidates
    perm = torch.argsort(keys_ln, dim=1, stable=True)
    sorted_keys = torch.gather(keys_ln, 1, perm)
    n = data.shape[0]
    pad = torch.full((cfg.L, cfg.max_candidates), n, dtype=torch.int64, device=dev)
    perm = torch.cat([perm, pad], dim=1).to(torch.int32)  # (L, n + C)
    payload, scales = get_codec(cfg.storage).encode(data)
    return ALSHIndex(
        tables=tables, mixers=mixers, sorted_keys=sorted_keys, perm=perm, data=payload,
        levels=levels, scales=scales,
    )


def hash_rows(
    index: ALSHIndex, rows: torch.Tensor, cfg: IndexConfig
) -> tuple[torch.Tensor, torch.Tensor]:
    """Hash new rows with the index's own tables: (m, d) f32 ->
    ((L, m) int32 keys, (m, d) int32 levels). This is what makes delta rows
    query-compatible with the sealed main segment."""
    levels = transforms.discretize(rows, cfg.space)
    keys = _keys_for(levels, None, index.tables, cfg, index.mixers).T
    return keys, levels


def delta_insert(
    index: ALSHIndex, delta: DeltaSegment, rows: torch.Tensor, cfg: IndexConfig
) -> tuple[DeltaSegment, torch.Tensor]:
    """Append rows to the delta segment (functional: ``delta`` is left as it
    was). rows (m, d) f32 on the index's device -> (new delta, (m,) int32
    assigned ids): ``n_main + slot``, and -1 for rows that did not fit
    (delta full: compact and retry); the fill clamps to the capacity."""
    m = rows.shape[0]
    cap = delta.capacity
    keys, levels = hash_rows(index, rows, cfg)  # the RAW rows
    # encode AFTER hashing, under the SEALED segment's scales, so a delta row
    # decodes as a main row does (int8 values outside its range saturate)
    enc = get_codec(cfg.storage).encode_rows(rows, index.scales).to(delta.data.dtype)
    fit = max(0, min(m, cap - delta.fill))
    lo, hi = delta.fill, delta.fill + fit
    data, lv, ks = delta.data.clone(), delta.levels.clone(), delta.keys.clone()
    data[lo:hi] = enc[:fit]
    lv[lo:hi] = levels[:fit]
    ks[:, lo:hi] = keys[:, :fit]
    slots = torch.arange(delta.fill, delta.fill + m, dtype=torch.int64, device=rows.device)
    ids = torch.where(slots < cap, index.n + slots, torch.full_like(slots, -1))
    return DeltaSegment(data, lv, ks, min(cap, delta.fill + m)), ids.to(torch.int32)


def tombstone_ids(
    tombstones: torch.Tensor, ids: torch.Tensor, n_main: int, fill: int
) -> torch.Tensor:
    """Set tombstone bits for ``ids`` (functional). Ids that name no row —
    negative, past the capacity, or in the UNFILLED delta range
    ``[n_main + fill, n_main + cap)`` — are ignored: tombstoning an
    unassigned slot would kill the row a future insert places there."""
    n_tot = tombstones.shape[0]
    ids = torch.as_tensor(ids, device=tombstones.device).reshape(-1).long()
    assigned = (ids >= 0) & (ids < n_main + fill) & (ids < n_tot)
    # unassigned ids land on one spare slot past the end, dropped after
    out = torch.cat([tombstones, tombstones.new_zeros(1)])
    out[torch.where(assigned, ids, torch.full_like(ids, n_tot))] = True
    return out[:n_tot]


# Delta-slot block size of the chunked key match: the per-step working set
# is (b, L, P, block) bools, whatever the delta capacity.
DELTA_MATCH_BLOCK = 1024


def _delta_candidates(
    probe_keys: torch.Tensor,
    delta: DeltaSegment,
    live: torch.Tensor,
    n_main: int,
    sentinel: int,
    block: int = DELTA_MATCH_BLOCK,
) -> torch.Tensor:
    """Delta probe: which delta slots collide with the query's keys.

    probe_keys (b, L) or (b, L, P); live (cap,) bool (slot filled and not
    tombstoned) -> (b, cap) int32 ids ``n_main + slot``, ``sentinel`` where
    the slot does not collide or is not live. A slot is a candidate iff its
    key equals one of the probe keys IN THE SAME TABLE — the predicate the
    sorted window applies to the main segment. The match runs over
    ``block``-slot chunks, never materializing (b, L, P, cap); chunks past
    the fill hold no live slot and are skipped (the output is the same).
    """
    cap = delta.capacity
    b = probe_keys.shape[0]
    out = torch.full((b, cap), sentinel, dtype=torch.int32, device=probe_keys.device)
    pk = probe_keys if probe_keys.ndim == 3 else probe_keys[:, :, None]  # (b, L, P)
    for s in range(0, min(delta.fill, cap), block):
        e = min(s + block, cap)
        kblk = delta.keys[:, s:e]  # (L, blk)
        match = (pk[:, :, :, None] == kblk[None, :, None, :]).flatten(1, 2).any(dim=1)
        ids = torch.arange(n_main + s, n_main + e, dtype=torch.int32, device=out.device)
        out[:, s:e] = torch.where(match & live[None, s:e], ids[None, :],
                                  torch.full_like(ids, sentinel)[None, :])
    return out


def _mask_dead(cand: torch.Tensor, tombstones: torch.Tensor, n_main: int,
               sentinel: int) -> torch.Tensor:
    """Zap probe-window padding (ids >= n_main) and tombstoned main ids to
    ``sentinel`` BEFORE the re-rank, so deleted rows never reach a result."""
    n_tot = tombstones.shape[0]
    dead = tombstones[torch.clamp(cand, max=n_tot - 1).long()]
    return torch.where((cand < n_main) & ~dead, cand, torch.full_like(cand, sentinel))


def delta_live_mask(delta: DeltaSegment, tombstones: torch.Tensor, n_main: int) -> torch.Tensor:
    """(cap,) bool: slot filled and not tombstoned."""
    slots = torch.arange(delta.capacity, device=tombstones.device)
    return (slots < delta.fill) & ~tombstones[n_main:]


def _payload_tensor(arr, storage: str, device) -> torch.Tensor:
    """The table payload in its stored dtype. A bf16 payload comes as the
    JAX package hands it over, with numpy dtype ``bfloat16`` (from
    ``ml_dtypes``), which torch cannot read: its 16-bit pattern is
    reinterpreted bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.tensor(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.tensor(arr)
    want = storage_dtype(storage)
    if t.dtype != want:
        raise ValueError(
            f"data payload is {t.dtype}, but IndexConfig.storage={storage!r} stores {want}"
        )
    return t.to(device)


def index_from_numpy(arrays: dict, cfg: IndexConfig, device) -> ALSHIndex:
    """The port's ``ALSHIndex`` from the reference's leaves as numpy arrays.

    ``arrays`` holds ``folded`` (H, d, M+1), ``offsets`` (H,), ``mixers``
    (L, K), ``sorted_keys`` (L, n), ``perm`` (L, n+C), ``data`` (n, d) — the
    payload in the ``cfg.storage`` dtype —, ``levels`` (n, d) and
    ``scales`` ((d,) f32, present exactly when the codec stores scales).
    """

    def t(name, dtype):
        return torch.tensor(np.asarray(arrays[name])).to(device=device, dtype=dtype)

    scaled = get_codec(cfg.storage).scaled
    if (arrays.get("scales") is not None) != scaled:
        raise ValueError(
            f"IndexConfig.storage={cfg.storage!r} {'needs' if scaled else 'takes no'} scales"
        )
    idx = ALSHIndex(
        tables=hf.PrefixTables(t("folded", torch.float32), t("offsets", torch.float32)),
        mixers=t("mixers", torch.int32),
        sorted_keys=t("sorted_keys", torch.int32),
        perm=t("perm", torch.int32),
        data=_payload_tensor(arrays["data"], cfg.storage, device),
        levels=t("levels", torch.int32),
        scales=t("scales", torch.float32) if scaled else None,
    )
    H, d, m1 = idx.tables.folded.shape
    n = idx.n
    if (H, d, m1) != (cfg.n_hashes, cfg.d, cfg.M + 1):
        raise ValueError(f"folded is {(H, d, m1)}, config needs {(cfg.n_hashes, cfg.d, cfg.M + 1)}")
    if tuple(idx.sorted_keys.shape) != (cfg.L, n) or tuple(idx.perm.shape) != (
        cfg.L, n + cfg.max_candidates,
    ):
        raise ValueError("sorted_keys/perm shapes do not match the config and data")
    if idx.scales is not None and tuple(idx.scales.shape) != (d,):
        raise ValueError(f"scales is {tuple(idx.scales.shape)}, config needs {(d,)}")
    return idx


def delta_from_numpy(
    arrays: dict, cfg: IndexConfig, capacity: int, n_main: int, device
) -> tuple[DeltaSegment, torch.Tensor]:
    """A mutable index's delta segment and tombstones from the reference's
    leaves as numpy arrays: ``delta_data`` (cap, d) in the ``cfg.storage``
    dtype, ``delta_levels`` (cap, d), ``delta_keys`` (L, cap), ``delta_fill``
    (a scalar) and ``tombstones`` (n_main + cap,) bool. Missing leaves give
    an empty delta of ``capacity`` slots and no tombstone."""
    if "delta_data" not in arrays:
        delta = DeltaSegment.empty(cfg, capacity, storage_dtype(cfg.storage), device)
    else:
        delta = DeltaSegment(
            data=_payload_tensor(arrays["delta_data"], cfg.storage, device),
            levels=torch.tensor(np.asarray(arrays["delta_levels"]), dtype=torch.int32,
                                device=device),
            keys=torch.tensor(np.asarray(arrays["delta_keys"]), dtype=torch.int32,
                              device=device),
            fill=int(np.asarray(arrays["delta_fill"]).reshape(-1)[0]),
        )
    if delta.capacity != capacity or tuple(delta.keys.shape) != (cfg.L, capacity):
        raise ValueError(f"delta leaves hold {delta.capacity} slots, UpdateSpec says {capacity}")
    if "tombstones" in arrays:
        tomb = torch.tensor(np.asarray(arrays["tombstones"]), dtype=torch.bool, device=device)
    else:
        tomb = torch.zeros((n_main + capacity,), dtype=torch.bool, device=device)
    if tuple(tomb.shape) != (n_main + capacity,):
        raise ValueError(f"tombstones is {tuple(tomb.shape)}, needs {(n_main + capacity,)}")
    return delta, tomb


def _searchsorted(sorted_keys: torch.Tensor, keys_lb: torch.Tensor, right: bool) -> torch.Tensor:
    """Batched over tables: sorted_keys (L, n), keys (L, m) -> (L, m) int64."""
    return torch.searchsorted(sorted_keys, keys_lb.to(sorted_keys.dtype).contiguous(), right=right)


def _probe_one_table(
    sorted_keys: torch.Tensor, perm: torch.Tensor, keys_lb: torch.Tensor, C: int
) -> torch.Tensor:
    """Sorted lookup + bounded candidate window, batched over tables.

    sorted_keys (L, n), perm (L, n + C), keys (L, m) -> (L, m, C) int32 ids;
    slots past the bucket end hold the sentinel n + C (``perm``'s width).
    """
    start = _searchsorted(sorted_keys, keys_lb, right=False)
    end = _searchsorted(sorted_keys, keys_lb, right=True)
    pos = start[:, :, None] + torch.arange(C, device=start.device)  # (L, m, C)
    L, m = keys_lb.shape
    ids = torch.gather(perm, 1, pos.reshape(L, m * C)).reshape(L, m, C)  # padded perm: in range
    sentinel = torch.full_like(ids, perm.shape[1])
    return torch.where(pos < end[:, :, None], ids, sentinel)


def _dedupe_candidates(cand: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack each row's distinct candidate ids below ``n`` first, ascending,
    then the sentinel ``n``: (b, P) -> ((b, P) int32, (b,) int32 counts).
    One kernel on the card (``ops.dedupe_candidates``), the two-sort plain
    version on the CPU."""
    return ops.dedupe_candidates(cand, n)


def table_window_sizes(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Rows sharing each probed bucket, before the ``max_candidates`` clamp:
    keys (b, L) single-probe or (b, L, P) multiprobe -> the same shape,
    int32. A window larger than ``max_candidates`` is truncated by the probe
    (what ``Index.explain`` reports)."""
    k3 = keys if keys.ndim == 3 else keys[..., None]  # (b, L, P)
    b, L, P = k3.shape
    kl = k3.permute(1, 0, 2).reshape(L, b * P)
    s = _searchsorted(sorted_keys, kl, right=False)
    e = _searchsorted(sorted_keys, kl, right=True)
    out = (e - s).reshape(L, b, P).permute(1, 0, 2).to(torch.int32)
    return out if keys.ndim == 3 else out[..., 0]


def query_keys_for(
    index: ALSHIndex, queries: torch.Tensor, weights: torch.Tensor, cfg: IndexConfig
) -> torch.Tensor:
    """(b, L) single-probe bucket keys of a query batch (the diagnostic entry
    point of ``Index.explain``; the query path computes the same keys inside
    ``repro_torch.engine.probe_keys``)."""
    qlevels = transforms.discretize(queries, cfg.space)
    return _keys_for(qlevels, weights, index.tables, cfg, index.mixers)


def query_index(
    index: ALSHIndex,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    k: int = 1,
    impl: str = "auto",
) -> QueryResult:
    """Batched ALSH query: probe L tables → dedupe → fused rerank/top-k (the
    reference's legacy entry; ``Index.query`` runs the same engine call).

    Args:
      queries: (b, d) float query points.
      weights: (b, d) float per-query weight vectors (the paper's w — may be negative).
      k: neighbours to return.
    """
    from repro_torch.engine import query

    return query(index, None, None, queries, weights, cfg, k=k, impl=impl)


def query_index_segmented(
    index: ALSHIndex,
    delta: DeltaSegment,
    tombstones: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    cfg: IndexConfig,
    k: int = 1,
    impl: str = "auto",
) -> QueryResult:
    """Two-segment ALSH query: sorted-window probe of the sealed main tables
    + key-match probe of the delta segment, tombstoned ids masked before
    dedupe/re-rank (a deleted row can never appear in a result), then one
    fused rerank/top-k tail gathering from both segment tables. Returned ids
    are global: main rows keep their build ids ``[0, n_main)``; delta slot
    ``s`` is ``n_main + s``."""
    from repro_torch.engine import query

    return query(index, delta, tombstones, queries, weights, cfg, k=k, impl=impl)
