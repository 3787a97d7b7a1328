"""The ``Index`` facade — counterpart of ``repro.api.index``.

    index = Index.build(seed, data, cfg)                     # on the GPU
    res   = index.query(q, w, QuerySpec(k=10))               # single-probe
    res   = index.query(q, w, QuerySpec(k=10, mode="multiprobe", n_probes=8))
    res   = index.query(q, w, QuerySpec(k=10, mode="exact")) # oracle scan

A config with ``storage="int8"`` or ``"bf16"`` keeps the table payload
encoded; ``QuerySpec(screen_alpha=α)`` screens it before the exact rerank.

``Index.build`` runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a card it raises rather than carry on on the CPU.
``Index.query`` runs on the index's device. ``Index.from_numpy`` carries an
index built by the JAX package across (the parity tests' entry point).
Mutable indexes, quality-first planning, persistence and sharding are not
ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import engine, not_ported
from repro_torch.api.spec import QualitySpec, QuerySpec, UpdateSpec
from repro_torch.core.families import n_flip_subsets
from repro_torch.core.index import (
    ALSHIndex,
    IndexConfig,
    QueryResult,
    build_index,
    index_from_numpy,
)


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA card; without one that is an error naming
    ``device="cpu"``, never a quiet switch to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and no CUDA device is "
            "available; pass device=\"cpu\" to run the plain PyTorch path on the CPU"
        )
    return dev


def as_generator(seed_or_generator) -> torch.Generator:
    """An int seeds a fresh CPU generator; a ``torch.Generator`` is used as is."""
    if isinstance(seed_or_generator, torch.Generator):
        return seed_or_generator
    if isinstance(seed_or_generator, int):
        return torch.Generator().manual_seed(seed_or_generator)
    raise TypeError(
        f"seed_or_generator must be an int or a torch.Generator, "
        f"got {type(seed_or_generator).__name__}"
    )


def validate_query_args(d: int, queries: torch.Tensor, weights: torch.Tensor) -> None:
    """Shape/batch/value validation of ``(queries, weights)``: malformed
    shapes raise a ValueError naming the argument, and non-finite rows raise
    a ValueError naming the row indices (a NaN would poison every distance)."""
    for name, arr in (("queries", queries), ("weights", weights)):
        if arr.ndim != 2 or arr.shape[-1] != d:
            raise ValueError(
                f"{name} must be (b, d) with trailing dim config.d={d}; "
                f"got {name}.shape={tuple(arr.shape)}"
            )
    if tuple(queries.shape[:-1]) != tuple(weights.shape[:-1]):
        raise ValueError(
            f"queries and weights batch dims disagree: "
            f"queries.shape={tuple(queries.shape)} vs "
            f"weights.shape={tuple(weights.shape)}"
        )
    for name, arr in (("queries", queries), ("weights", weights)):
        finite_rows = torch.isfinite(arr).all(dim=1)
        if not bool(finite_rows.all()):
            bad = torch.nonzero(~finite_rows).flatten().tolist()
            head = ", ".join(map(str, bad[:8])) + (", …" if len(bad) > 8 else "")
            raise ValueError(
                f"{name} contains non-finite values (NaN/Inf) in "
                f"{len(bad)} of {finite_rows.numel()} rows [{head}] — "
                f"non-finite {name} would silently produce NaN distances "
                f"through the rerank tail; filter or clamp them first"
            )


def _check_probe_reach(cfg: IndexConfig, spec: QuerySpec) -> None:
    """Reject multiprobe specs asking for more probes than the (K,
    max_flips) perturbation enumeration can reach — beyond that count every
    extra probe re-probes a duplicate bucket and buys nothing."""
    if spec.mode != "multiprobe":
        return
    cap = n_flip_subsets(cfg.K, spec.max_flips)
    if spec.n_probes > cap:
        raise ValueError(
            f"QuerySpec.n_probes={spec.n_probes} exceeds the "
            f"{cap} distinct probe keys reachable with K={cfg.K} "
            f"hash bits and max_flips={spec.max_flips} — extra probes "
            f"would silently hit duplicate buckets; lower n_probes or "
            f"raise max_flips"
        )


@dataclasses.dataclass
class Index:
    """A built sealed ALSH index that owns its static configuration."""

    state: ALSHIndex
    config: IndexConfig

    @classmethod
    def build(
        cls,
        seed_or_generator,
        data,
        config: "IndexConfig | QualitySpec",
        update: UpdateSpec = UpdateSpec(),
        device=None,
    ) -> "Index":
        """Hash every row and sort each table (Theorem 1 preprocessing) on
        ``device`` (default: the CUDA card). The tables are drawn from the
        seed or generator on the CPU, so a seed gives the same index on
        every device."""
        if isinstance(config, QualitySpec):
            raise not_ported("Index.build(QualitySpec) — quality-first planning", "Queue A item 10")
        if update.mutable:
            raise not_ported("UpdateSpec(delta_capacity>0) — the mutable index", "Queue A item 7")
        dev = resolve_device(device)
        gen = as_generator(seed_or_generator)
        data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
        if data.ndim != 2 or data.shape[1] != config.d:
            raise ValueError(
                f"data must be (n, d) with d=config.d={config.d}, got {tuple(data.shape)}"
            )
        return cls(state=build_index(gen, data, config), config=config)

    @classmethod
    def from_numpy(cls, arrays: dict, config: IndexConfig, device=None) -> "Index":
        """An index from the reference's ``ALSHIndex`` leaves as numpy
        arrays (see ``repro_torch.core.index.index_from_numpy``)."""
        dev = resolve_device(device)
        return cls(state=index_from_numpy(arrays, config, dev), config=config)

    @property
    def n(self) -> int:
        return self.state.n

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def table_bytes(self) -> int:
        """Resident bytes of the row table (payload + decode scales) — the
        memory the storage codec compresses. Hash tables and permutations
        are excluded: they are storage-invariant."""
        total = self.state.data.nbytes
        if self.state.scales is not None:
            total += self.state.scales.nbytes
        return int(total)

    def query(self, queries, weights, spec=QuerySpec()) -> QueryResult:
        """Batched k-NN under d_w^l1 on the index's device. ``spec`` is a
        :class:`QuerySpec` (mode "probe", "multiprobe" or "exact"). Invalid
        result slots are ``ids == -1`` / ``dists == +inf``."""
        if isinstance(spec, QualitySpec):
            raise not_ported("Index.query(QualitySpec) — quality-first planning", "Queue A item 10")
        if not isinstance(spec, QuerySpec):
            raise TypeError(f"spec must be a QuerySpec; got {type(spec).__name__}")
        queries = torch.as_tensor(queries)
        weights = torch.as_tensor(weights)
        validate_query_args(self.config.d, queries, weights)
        _check_probe_reach(self.config, spec)
        return engine.query(
            self.state, None, None, queries, weights, self.config, k=spec.k, mode=spec.mode,
            n_probes=spec.n_probes, max_flips=spec.max_flips, screen_alpha=spec.screen_alpha,
        )

    def shard(self, *args, **kwargs):
        raise not_ported("Index.shard — the sharded service", "Queue A item 12")
