"""The sealed ALSH index — counterpart of ``repro.core.index``.

Each of the L tables is a sorted key column:

  build:  codes (n, K) --combine--> keys (n,) --stable argsort--> (sorted_keys, perm)
  query:  key --searchsorted--> [start, end) --bounded window--> candidate ids

This module owns the data structure (``IndexConfig``, ``ALSHIndex``,
``build_index``) and the probe primitives (``_probe_one_table``,
``_dedupe_candidates``, ``table_window_sizes``); query execution lives in
:mod:`repro_torch.engine`. The sealed segment is ported with every storage
codec (f32, bf16, int8; ``repro_torch.quant``); the delta segment and
tombstones are ROADMAP.md Queue A item 7.

``index_from_numpy`` carries an index the JAX package built (its
``ALSHIndex`` leaves as numpy arrays) into this package, which is how the
parity tests hold both packages to the same random tables.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import hash_families as hf
from repro_torch.core import transforms
from repro_torch.core.families import HashFamily, get_family
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
    ``dists == +inf``; internal candidate sentinels never escape."""

    dists: torch.Tensor  # (b, k) ascending d_w^l1
    ids: torch.Tensor  # (b, k) int32 point ids
    n_candidates: torch.Tensor  # (b,) int32 unique candidates examined


def _keys_for(
    levels: torch.Tensor,
    weights: torch.Tensor | None,
    tables: hf.PrefixTables,
    cfg: IndexConfig,
    mixers: torch.Tensor,
) -> torch.Tensor:
    """Hash points/queries to per-table keys: (b, d)[, (b, d) w] -> (b, L) int32."""
    params = cfg.lsh_params
    if weights is None:
        codes = hf.hash_data(levels, tables, params)
    else:
        codes = hf.hash_query(levels, weights, tables, params)
    codes = codes.reshape(*codes.shape[:-1], cfg.L, cfg.K)
    return get_family(cfg.family).combine_codes(codes, mixers, cfg.K)


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
        tables = hf.make_prefix_tables(generator, cfg.lsh_params)
        # odd int32 multipliers in [1, 2**31 - 1) (the l2 family's key mixing)
        mixers = torch.randint(1, INT32_MAX, (cfg.L, cfg.K), generator=generator,
                               dtype=torch.int64)
        mixers = (mixers | 1).to(torch.int32)
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
    """Sort candidate ids, zap duplicates/invalids to the sentinel ``n`` and
    pack the unique ids first: (b, P) -> ((b, P) int32, (b,) int32 counts)."""
    cand = torch.sort(torch.clamp(cand, max=n), dim=1).values
    first = torch.ones_like(cand, dtype=torch.bool)
    first[:, 1:] = cand[:, 1:] != cand[:, :-1]
    valid = (cand < n) & first
    packed = torch.sort(torch.where(valid, cand, torch.full_like(cand, n)), dim=1).values
    return packed.to(torch.int32), valid.sum(dim=1).to(torch.int32)


def table_window_sizes(sorted_keys: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Rows sharing each probed bucket, before the ``max_candidates`` clamp:
    keys (b, L) -> (b, L) int32."""
    kl = keys.T
    s = _searchsorted(sorted_keys, kl, right=False)
    e = _searchsorted(sorted_keys, kl, right=True)
    return (e - s).T.to(torch.int32)
