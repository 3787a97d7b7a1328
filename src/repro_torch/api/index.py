"""The ``Index`` facade — counterpart of ``repro.api.index``.

    index = Index.build(seed, data, cfg)                     # on the GPU
    res   = index.query(q, w, QuerySpec(k=10))               # single-probe
    res   = index.query(q, w, QuerySpec(k=10, mode="multiprobe", n_probes=8))
    res   = index.query(q, w, QuerySpec(k=10, mode="exact")) # oracle scan

A config with ``storage="int8"`` or ``"bf16"`` keeps the table payload
encoded; ``QuerySpec(screen_alpha=α)`` screens it before the exact rerank.

An index built with ``UpdateSpec(delta_capacity=C)`` is mutable:

    index = Index.build(seed, data, cfg, update=UpdateSpec(delta_capacity=C))
    index, ids = index.insert(rows)     # functional; ids are stable
    index = index.delete(ids[:16])      # tombstones, never re-sorts
    res = index.query(q, w, spec)       # two-segment query, same contract
    if index.needs_compact: index = index.compact()   # the only sort

``QuerySpec(early_exit=True, exit_group=G, exit_slack=s)`` streams the
probe windows G at a time and stops each query early;
``index.explain(q, w, spec)`` runs the query and returns a
:class:`~repro_torch.api.planner.QueryReport` of per-query diagnostics.

``index.save(directory)`` writes the reference's directory format
(version 5: ``index.json`` and a committed msgpack payload, see
:mod:`repro_torch.api.persist`); ``Index.load(directory)`` reads versions
1–5, whichever package wrote them.

``Index.build`` and ``Index.load`` run on ``device="cuda"`` unless the
caller passes ``device="cpu"``; without a card they raise rather than carry
on on the CPU. ``Index.query`` runs on the index's device.
``Index.from_numpy`` carries an index built by the JAX package across (the
parity tests' entry point).

Quality first: state what, not how, and the planner derives the rest —

    index = Index.build(seed, data, QualitySpec(k=10, recall_target=0.9))
    res   = index.query(q, w, quality)          # == query(q, w, index.plan(quality))
    ladder = index.plan_ladder(quality)         # rung 0 == index.plan(quality)

The geometry comes from theory inversion on the data, the execution plan
from a calibration pass on the built index (memoized in ``index.plans``);
when even the best plan misses the target, L is doubled (twice at most,
within ``Planner.max_L``) and the index rebuilt from the same generator
state.

Sharded serving (one process drives every shard; a device may repeat):

    mesh    = make_mesh((2, 2, 2), ("pod", "data", "model"),
                        devices=[torch.device("cuda", 0)] * 8)
    sharded = index.shard(mesh)                  # a ShardedIndex
    res     = sharded.query(q, w, QuerySpec(k=10))   # global ids, merged
"""

from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch

from repro_torch import engine, obs
from repro_torch.api import persist
from repro_torch.api.planner import Planner, QueryReport
from repro_torch.api.spec import PlannedSpec, QualitySpec, QuerySpec, UpdateSpec
from repro_torch.core import theory
from repro_torch.core.families import n_flip_subsets
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    build_index,
    delta_from_numpy,
    delta_insert,
    index_from_numpy,
    query_keys_for,
    table_window_sizes,
    tombstone_ids,
)
from repro_torch.core.multiprobe import multiprobe_keys_for
from repro_torch.quant import decode_table, get_codec, screen_keep


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
    """A built ALSH index that owns its static configuration and lifecycle.

    ``state`` is the sealed main segment (only ``compact`` replaces it);
    ``update`` the mutability policy; ``delta`` the fixed-capacity segment of
    post-build inserts (capacity 0 for a sealed index); ``tombstones``
    (n_main + capacity,) bool marks deleted rows of either segment. Row ids
    are stable across mutation: main rows keep their build ids, the i-th
    inserted row gets ``n_main + i``; only ``compact`` renumbers, per
    ``live_ids``. The lifecycle methods are functional: each returns a new
    ``Index`` and leaves this one as it was.

    Three fields travel through ``save``/``load``: ``build_key``, the
    reference's JAX PRNG key as a numpy uint32 array (None for an index this
    package built, which saves ``persist.PORT_BUILT_KEY``); ``plans``, the
    memo ``QualitySpec -> PlannedSpec``; ``tuning``, the provenance stamp of
    the tuning table behind a prior plan. Two host-side memos do not:
    ``ladders`` (``plan_ladder``'s resolutions) and ``plan_times`` (each
    resolution's wall seconds in this process). ``insert`` and ``delete``
    share every memo with the index they came from; ``compact`` keeps
    ``build_key`` and drops the rest.
    """

    state: ALSHIndex
    config: IndexConfig
    update: UpdateSpec = UpdateSpec()
    delta: DeltaSegment | None = None
    tombstones: torch.Tensor | None = None
    build_key: np.ndarray | None = dataclasses.field(default=None, compare=False)
    plans: dict = dataclasses.field(default_factory=dict, compare=False)
    tuning: dict | None = dataclasses.field(default=None, compare=False)
    ladders: dict = dataclasses.field(default_factory=dict, compare=False)
    plan_times: dict = dataclasses.field(default_factory=dict, compare=False)

    def __post_init__(self):
        # empty mutation state when constructed without it (sealed indexes)
        if self.delta is None:
            self.delta = DeltaSegment.empty(self.config, self.update.delta_capacity,
                                            dtype=self.state.data.dtype, device=self.device)
        if self.tombstones is None:
            self.tombstones = torch.zeros((self.state.n + self.delta.capacity,),
                                          dtype=torch.bool, device=self.device)

    @classmethod
    def build(
        cls,
        seed_or_generator,
        data,
        config: "IndexConfig | QualitySpec",
        update: UpdateSpec = UpdateSpec(),
        device=None,
        family: str = "auto",
        M: int = 32,
        planner: Planner | None = None,
    ) -> "Index":
        """Hash every row and sort each table (Theorem 1 preprocessing) on
        ``device`` (default: the CUDA card). The tables are drawn from the
        seed or generator on the CPU, so a seed gives the same index on
        every device. ``update=UpdateSpec(delta_capacity=C)`` reserves C
        delta slots and makes the index mutable.

        ``config`` is an explicit :class:`IndexConfig` or a
        :class:`QualitySpec`; then ``planner`` (default ``Planner()``)
        derives the geometry from the data (``family``, ``M``), calibrates
        and memoizes the execution plan, and while the best plan misses
        ``recall_target`` doubles L (at most twice, within
        ``planner.max_L``) and rebuilds from the same generator state. The
        last attempt's planner warnings are re-raised."""
        dev = resolve_device(device)
        gen = as_generator(seed_or_generator)
        data = torch.as_tensor(data).to(device=dev, dtype=torch.float32)
        d = config.d if isinstance(config, IndexConfig) else data.shape[-1]
        if data.ndim != 2 or data.shape[1] != d:
            raise ValueError(f"data must be (n, d) with d=config.d={d}, got {tuple(data.shape)}")
        if not isinstance(config, QualitySpec):
            return cls(state=build_index(gen, data, config), config=config, update=update)

        quality = config
        planner = planner or Planner()
        cfg = planner.plan_config(data, quality, family=family, M=M)
        start = gen.get_state()
        last_round = 2  # escalation attempts: L x2 each, then accept the best
        for attempt in range(last_round + 1):
            gen.set_state(start)  # every attempt draws the tables a fresh build would
            index = cls(state=build_index(gen, data, cfg), config=cfg, update=update)
            at_cap = cfg.L >= planner.max_L
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                planned = planner.plan_query(index, quality)
                index._record_plan(quality, planned, planner, time.perf_counter() - t0)
            if planned.predicted_recall >= quality.recall_target - 1e-9 or (
                attempt == last_round or at_cap
            ):
                # this attempt's plan is the caller's: its warnings are real
                for w in caught:
                    warnings.warn(w.message, w.category, stacklevel=2)
                return index
            # a miss with room to escalate: the rebuild supersedes the warnings
            cfg = dataclasses.replace(cfg, L=min(2 * cfg.L, planner.max_L))

    @classmethod
    def from_numpy(cls, arrays: dict, config: IndexConfig, update: UpdateSpec = UpdateSpec(),
                   device=None) -> "Index":
        """An index from the reference's leaves as numpy arrays: the
        ``ALSHIndex`` leaves (see ``repro_torch.core.index.index_from_numpy``)
        and, for a mutable index, its delta leaves and tombstones (see
        ``delta_from_numpy``) under the reference's ``update``."""
        dev = resolve_device(device)
        state = index_from_numpy(arrays, config, dev)
        delta, tomb = delta_from_numpy(arrays, config, update.delta_capacity, state.n, dev)
        return cls(state=state, config=config, update=update, delta=delta, tombstones=tomb)

    @property
    def n(self) -> int:
        """Main-segment (sealed) rows."""
        return self.state.n

    @property
    def d(self) -> int:
        return self.config.d

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def mutable(self) -> bool:
        return self.update.mutable

    @property
    def capacity(self) -> int:
        """Total addressable rows: main + delta slots."""
        return self.state.n + self.delta.capacity

    @property
    def delta_fill(self) -> int:
        """Delta slots used (a host int: no device sync)."""
        return self.delta.fill

    @property
    def n_live(self) -> int:
        """Surviving rows: filled, not tombstoned."""
        return int(self.live_ids().size)

    @property
    def needs_compact(self) -> bool:
        """Advisory: the delta fill reached ``update.compact_threshold``."""
        cap = self.delta.capacity
        if cap == 0:
            return False
        return self.delta_fill >= self.update.compact_threshold * cap

    @property
    def table_bytes(self) -> int:
        """Resident bytes of the row tables (main payload + delta payload +
        decode scales) — the memory the storage codec compresses. Hash
        tables and permutations are excluded: they are storage-invariant."""
        total = self.state.data.nbytes + self.delta.data.nbytes
        if self.state.scales is not None:
            total += self.state.scales.nbytes
        return int(total)

    def resolve(self, spec) -> tuple[QuerySpec, IndexConfig, PlannedSpec | None]:
        """Any spec kind as (mechanism QuerySpec, effective config, the
        PlannedSpec or None): a QualitySpec goes through the memoized
        planner, a PlannedSpec applies its window to the config. ``query``
        and ``explain`` both resolve here, which is what makes ``query(q,
        w, quality)`` equal ``query(q, w, index.plan(quality))``."""
        if isinstance(spec, QualitySpec):
            spec = self.plan(spec)
        if isinstance(spec, PlannedSpec):
            return spec.to_query_spec(), spec.effective_config(self.config), spec
        if not isinstance(spec, QuerySpec):
            raise TypeError(
                f"spec must be a QuerySpec, QualitySpec, or PlannedSpec; "
                f"got {type(spec).__name__}"
            )
        return spec, self.config, None

    def plan(self, quality: QualitySpec, planner: Planner | None = None) -> PlannedSpec:
        """Resolve ``quality`` to a :class:`PlannedSpec`, memoized on this
        index (and shared with the indexes ``insert``/``delete`` derive
        from it). Deterministic given (index, ``quality.seed``); persists
        through ``save``/``load``."""
        planned = self.plans.get(quality)
        if planned is None:
            planner = planner or Planner()
            t0 = time.perf_counter()
            planned = planner.plan_query(self, quality)
            self._record_plan(quality, planned, planner, time.perf_counter() - t0)
        return planned

    def _record_plan(self, quality, planned, planner, elapsed: float) -> None:
        """Memoize a resolution with its wall seconds and, for a prior plan,
        the provenance stamp of the tuning table behind it."""
        self.plans[quality] = planned
        self.plan_times[quality] = elapsed
        if planned.provenance == "prior" and getattr(planner, "table", None) is not None:
            self.tuning = planner.table.provenance()

    def plan_ladder(self, quality: QualitySpec, planner: Planner | None = None) -> tuple:
        """The degradation ladder for ``quality`` (memoized): rung 0 is what
        ``plan(quality)`` returns, every later rung strictly cheaper, each
        with its calibrated ``predicted_recall``. One calibration pass; it
        also seeds the ``plans`` memo."""
        ladder = self.ladders.get(quality)
        if ladder is None:
            ladder = (planner or Planner()).plan_ladder(self, quality)
            self.ladders[quality] = ladder
            self.plans.setdefault(quality, ladder[0])
        return ladder

    def query(self, queries, weights, spec=QuerySpec()) -> QueryResult:
        """Batched k-NN under d_w^l1 on the index's device. ``spec`` is a
        :class:`QuerySpec` (mode "probe", "multiprobe" or "exact"), a
        :class:`PlannedSpec`, or a :class:`QualitySpec` (planned on first
        use, memoized after). A mutable index adds the delta key match and
        the tombstone mask to the sealed window source. Invalid result
        slots are ``ids == -1`` / ``dists == +inf``. Under a profiler the
        call is the span ``repro_torch.query`` (:mod:`repro_torch.obs`)."""
        with obs.span("query"):
            queries = torch.as_tensor(queries)
            weights = torch.as_tensor(weights)
            with obs.span("validate"):
                validate_query_args(self.config.d, queries, weights)
            qspec, cfg, _ = self.resolve(spec)
            _check_probe_reach(cfg, qspec)
            return engine.query(
                self.state,
                self.delta if self.mutable else None,
                self.tombstones if self.mutable else None,
                queries, weights, cfg, k=qspec.k, mode=qspec.mode,
                n_probes=qspec.n_probes, max_flips=qspec.max_flips,
                screen_alpha=qspec.screen_alpha, early_exit=qspec.early_exit,
                exit_group=qspec.exit_group, exit_slack=qspec.exit_slack, impl=qspec.impl,
            )

    def explain(self, queries, weights, spec=QuerySpec()) -> QueryReport:
        """Run ``query`` and return a :class:`QueryReport` wrapping the result
        with per-query diagnostics: the spec that ran (and the QualitySpec,
        provenance and planning seconds of a planned one), the Thm 1
        success probability predicted from Eq 25/27 at each query's own
        weights, candidate counts, window truncation, sentinel slots, the
        storage tier's byte accounting and, for a streamed early-exit query,
        ``tables_probed``/``stop_reason``. The answer is the one a plain
        ``query`` with the same spec gives."""
        queries = torch.as_tensor(queries)
        weights = torch.as_tensor(weights)
        validate_query_args(self.config.d, queries, weights)
        quality = spec if isinstance(spec, QualitySpec) else None
        qspec, cfg, planned = self.resolve(spec)
        res = self.query(queries, weights, planned if planned is not None else qspec)
        dev = self.device
        queries = queries.to(device=dev, dtype=torch.float32).contiguous()
        weights = weights.to(device=dev, dtype=torch.float32).contiguous()
        b = queries.shape[0]
        if qspec.mode == "exact":
            truncated = np.zeros((b,), np.int32)
        else:
            if qspec.mode == "multiprobe":
                keys = multiprobe_keys_for(self.state, queries, weights, cfg, qspec.n_probes,
                                           qspec.max_flips)  # (b, L, P)
            else:
                keys = query_keys_for(self.state, queries, weights, cfg)  # (b, L)
            over = table_window_sizes(self.state.sorted_keys, keys) > cfg.max_candidates
            truncated = over.reshape(b, -1).sum(dim=1).to(torch.int32).cpu().numpy()

        # Thm 1 success bound per query at its OWN w and observed top-1 r
        # (result distances are raw-unit; Eq 25/27 want lattice units — x t)
        top1 = res.dists[:, 0]
        valid1 = torch.isfinite(top1)
        r1 = torch.where(valid1, top1, torch.zeros_like(top1)) * cfg.space.t
        if cfg.family == "l2":
            p1 = theory.collision_prob_l2(r1, cfg.M, cfg.d, weights, cfg.W)
        else:
            p1 = theory.collision_prob_theta(r1, cfg.M, cfg.d, weights)
        p1 = torch.clamp(p1, 1e-12, 1.0 - 1e-12)
        miss = theory.int_pow(1.0 - theory.int_pow(p1, cfg.K), cfg.L)
        success = torch.where(valid1, 1.0 - miss, torch.zeros_like(miss))

        # storage-tier accounting: what the fused tail moved. The screen
        # gathers every unique candidate once at the ENCODED row width; the
        # exact rerank then re-gathers the survivors (all candidates when
        # the screen is off).
        n_cand = res.n_candidates.cpu().numpy().astype(np.int64)
        row_bytes = self.state.data.element_size() * cfg.d
        if qspec.mode != "exact" and self.state.data.dtype != torch.float32:
            p_slots = qspec.n_probes if qspec.mode == "multiprobe" else 1
            n_slots = cfg.L * p_slots * cfg.max_candidates + (
                self.delta.capacity if self.mutable else 0
            )
            keep = screen_keep(qspec.k, qspec.screen_alpha, n_slots)
        else:
            keep = 0
        rows_screened = n_cand if keep else np.zeros_like(n_cand)
        rows_reranked = np.minimum(n_cand, keep) if keep else n_cand
        bytes_gathered = (rows_screened + rows_reranked) * row_bytes

        def host(t):
            return None if t is None else t.cpu().numpy().astype(np.int32)

        return QueryReport(
            spec=planned if planned is not None else qspec,
            quality=quality,
            result=res,
            predicted_success=success.cpu().numpy(),
            n_candidates=res.n_candidates.cpu().numpy(),
            truncated_tables=truncated,
            n_invalid=(res.ids < 0).sum(dim=1).to(torch.int32).cpu().numpy(),
            provenance=planned.provenance if planned is not None else None,
            plan_build_s=self.plan_times.get(quality) if quality is not None else None,
            storage=cfg.storage,
            rows_screened=rows_screened,
            rows_reranked=rows_reranked,
            bytes_gathered=bytes_gathered,
            table_bytes=self.table_bytes,
            tables_probed=host(res.tables_probed),
            stop_reason=host(res.stop_reason),
        )

    # -- mutation (functional: every method returns a new Index) ------------
    def _require_mutable(self, op: str) -> None:
        if not self.mutable:
            raise ValueError(
                f"Index.{op}() requires a mutable index — build with "
                f"update=UpdateSpec(delta_capacity=...) (this index was built "
                f"with delta_capacity=0)"
            )

    def insert(self, rows) -> tuple["Index", torch.Tensor]:
        """Append (m, d) rows to the delta segment, hashed with the index's
        own tables. Returns (new index, (m,) int32 assigned ids); ids are
        stable until the next ``compact``, and -1 marks rows that did not fit
        (delta at capacity: compact and retry)."""
        self._require_mutable("insert")
        rows = torch.as_tensor(rows)
        if rows.ndim != 2 or rows.shape[-1] != self.config.d:
            raise ValueError(
                f"insert rows must be (m, d) with trailing dim "
                f"config.d={self.config.d}; got rows.shape={tuple(rows.shape)}"
            )
        rows = rows.to(device=self.device, dtype=torch.float32).contiguous()
        delta, ids = delta_insert(self.state, self.delta, rows, self.config)
        return dataclasses.replace(self, delta=delta), ids

    def delete(self, ids) -> "Index":
        """Tombstone rows by id (either segment). Unknown ids — negative or
        not yet assigned by any insert — are ignored; deleted ids never
        appear in query results. Space is reclaimed by ``compact``."""
        self._require_mutable("delete")
        ts = tombstone_ids(self.tombstones, ids, self.state.n, self.delta.fill)
        return dataclasses.replace(self, tombstones=ts)

    def live_ids(self) -> np.ndarray:
        """(n_live,) int64 numpy array: surviving row ids in compaction
        order — ``live_ids()[new_id] == old_id`` after ``compact()``."""
        tomb = self.tombstones.cpu().numpy()
        n_main = self.state.n
        main_keep = np.nonzero(~tomb[:n_main])[0]
        delta_keep = n_main + np.nonzero(~tomb[n_main : n_main + self.delta.fill])[0]
        return np.concatenate([main_keep, delta_keep])

    def compact(self) -> "Index":
        """Merge the surviving main rows and delta rows into a fresh sealed
        segment; the only lifecycle operation that sorts.

        Hashes are not recomputed: main-row keys are recovered by inverting
        each table's permutation (over ``perm[:, :n_main]``, whose padding
        holds n) and delta-row keys were computed at insert time, so the
        merge is a gather plus L stable argsorts — equal to ``Index.build``
        over the surviving rows with the same tables and mixers. Survivors
        are decoded and re-encoded as a new segment (int8 scales are refit).
        Returns a new index with an empty delta and no tombstones; ids are
        renumbered per ``live_ids()``."""
        self._require_mutable("compact")
        state, cfg = self.state, self.config
        n_main, fill = state.n, self.delta.fill
        tomb = self.tombstones
        main_keep = torch.nonzero(~tomb[:n_main]).flatten()
        delta_keep = torch.nonzero(~tomb[n_main : n_main + fill]).flatten()

        # keys of the main rows at their build positions: keys[l, perm[l, i]] = sorted_keys[l, i]
        keys_main = torch.zeros((cfg.L, n_main), dtype=torch.int32, device=self.device)
        keys_main.scatter_(1, state.perm[:, :n_main].long(), state.sorted_keys)

        # f32: decode and encode are the identity; int8: decoded with the old
        # scales, re-encoded with scales refit to the survivors
        data = torch.cat([
            decode_table(state.data[main_keep], state.scales),
            decode_table(self.delta.data[delta_keep].to(state.data.dtype), state.scales),
        ])
        levels = torch.cat([state.levels[main_keep], self.delta.levels[delta_keep]])
        keys_ln = torch.cat([keys_main[:, main_keep], self.delta.keys[:, delta_keep]], dim=1)

        # build_index's tail over the survivors: the stable sort, the padding
        n_new = data.shape[0]
        perm = torch.argsort(keys_ln, dim=1, stable=True)
        sorted_keys = torch.gather(keys_ln, 1, perm)
        pad = torch.full((cfg.L, cfg.max_candidates), n_new, dtype=torch.int64,
                         device=self.device)
        perm = torch.cat([perm, pad], dim=1).to(torch.int32)
        payload, scales = get_codec(cfg.storage).encode(data)
        new_state = ALSHIndex(
            tables=state.tables, mixers=state.mixers, sorted_keys=sorted_keys, perm=perm,
            data=payload, levels=levels, scales=scales,
        )
        return Index(state=new_state, config=cfg, update=self.update, build_key=self.build_key)

    # -- persistence (self-describing) --------------------------------------
    def save(self, directory) -> str:
        """Write a directory restorable by ``Index.load(directory)`` alone
        (this package's or the reference's): config, update policy, every
        segment, the tombstones, the plan memo and the tuning stamp."""
        return persist.save_index(
            directory, self.state, self.build_key, self.config, update=self.update,
            delta=self.delta, tombstones=self.tombstones, plans=self.plans, tuning=self.tuning,
        )

    @classmethod
    def load(cls, directory, device=None) -> "Index":
        """Restore an index from a directory that either package saved,
        every tensor on ``device`` (default: the CUDA card)."""
        dev = resolve_device(device)
        state, build_key, cfg, update, delta, tombstones, plans, tuning = persist.load_index(
            directory, dev
        )
        return cls(state=state, config=cfg, update=update, delta=delta, tombstones=tombstones,
                   build_key=build_key, plans=plans, tuning=tuning)

    # -- distribution -------------------------------------------------------
    def shard(self, mesh, merge_hierarchical: bool = True) -> "ShardedIndex":
        """Partition the main rows over ``mesh`` (a
        :class:`~repro_torch.core.distributed.Mesh`, see ``make_mesh``) for
        the sharded service. Each shard's local index is built once, with
        this index's tables and mixers, on its own device. A mutable index
        replays its delta rows through the sharded insert (the same tables
        hash them to the same keys, so ids are kept: ``n_main + i`` for the
        i-th insert) and then its tombstones through ``delete``; each shard
        gets ``update.delta_capacity / S`` delta slots. Returns a
        :class:`ShardedIndex` with the same query/insert/delete surface."""
        from repro_torch.core.distributed import Mesh, build_local_indexes, make_sharded_delta

        if not isinstance(mesh, Mesh):
            raise TypeError(
                f"Index.shard(mesh) takes a repro_torch.core.distributed.Mesh "
                f"(make_mesh(shape, axis_names, devices=...)), got {type(mesh).__name__}"
            )
        if self.config.storage != "f32":
            raise ValueError(
                f"Index.shard() supports storage='f32' only (this index was "
                f"built with storage={self.config.storage!r}) — the mesh path "
                f"re-discretizes raw rows per shard, and per-shard re-encoding "
                f"would drift the quantization grid away from the single-host "
                f"index it must answer bit-identically to. Use the host-side "
                f"serving shard set (repro_torch.serving.chaos.ShardSet), which "
                f"re-encodes each shard self-consistently, or build with "
                f"storage='f32' before sharding"
            )
        S = mesh.size
        if self.mutable and self.update.delta_capacity % S:
            raise ValueError(
                f"UpdateSpec.delta_capacity={self.update.delta_capacity} must "
                f"be a multiple of the mesh size ({S} devices) — each shard "
                f"owns an equal slice of the delta segment"
            )
        index_sharded = build_local_indexes(self.state.tables, self.state.mixers,
                                            self.state.data, self.config, mesh)
        sharded = ShardedIndex(
            index_sharded=index_sharded, config=self.config, mesh=mesh,
            merge_hierarchical=merge_hierarchical, update=self.update,
            build_key=self.build_key, plans=dict(self.plans),
        )
        if self.mutable:
            sharded.delta_sharded, sharded.tombstones_sharded = make_sharded_delta(
                self.config, mesh, self.update.delta_capacity // S, self.state.data.dtype,
                n_local=self.n // S,
            )
            if self.delta_fill:
                sharded, _ = sharded.insert(self.delta.data[: self.delta_fill])
            gids = torch.nonzero(self.tombstones).flatten()
            if gids.numel():
                sharded = sharded.delete(gids)
        return sharded


@dataclasses.dataclass
class ShardedIndex:
    """Row-sharded view of an :class:`Index` for the sharded service.

    Shard s owns a contiguous block of n_local main rows and a complete
    local index over it on ``mesh.devices.flat[s]``; the hash tables are the
    parent's on every shard. ``query()`` returns globally merged results
    with global row ids, on ``mesh.devices.flat[0]``.

    A mutable index shards too: each shard owns a private
    ``update.delta_capacity / n_shards``-slot delta slice, inserts route
    round-robin by global id, deletes tombstone on the owning shard, and the
    ids are the single-host :class:`Index`'s (main row i <-> gid i; the i-th
    inserted row <-> gid n_main + i) — so a sharded and a single-host index
    fed the same update stream return the same ids.
    """

    index_sharded: list  # ALSHIndex per shard, in rank order
    config: IndexConfig
    mesh: object
    merge_hierarchical: bool = True
    update: UpdateSpec = UpdateSpec()
    build_key: np.ndarray | None = dataclasses.field(default=None, compare=False)
    delta_sharded: list | None = None  # DeltaSegment per shard
    tombstones_sharded: list | None = None  # (n_local + cap,) bool per shard
    plans: dict = dataclasses.field(default_factory=dict, compare=False)  # from the parent

    @property
    def n(self) -> int:
        return sum(state.n for state in self.index_sharded)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def mutable(self) -> bool:
        return self.update.mutable and self.delta_sharded is not None

    @property
    def _cap_local(self) -> int:
        """Delta slots per shard (delta_capacity is the index-wide total)."""
        return self.update.delta_capacity // self.n_shards

    @property
    def delta_fill(self) -> int:
        """Delta slots used across shards (host ints: no device sync)."""
        if self.delta_sharded is None:
            return 0
        return sum(d.fill for d in self.delta_sharded)

    @property
    def needs_compact(self) -> bool:
        """Advisory: ANY shard's delta slice reached the compact threshold
        (that shard starts dropping inserts first)."""
        if self.delta_sharded is None:
            return False
        limit = self.update.compact_threshold * self._cap_local
        return any(d.fill >= limit for d in self.delta_sharded)

    def query(self, queries, weights, spec=QuerySpec()):
        """``Index.query``'s contract over the shards, with the same argument
        validation; each shard runs the engine over its slice and the top-k
        merge composes the answers (a ``ShardedQueryResult``). A QualitySpec
        resolves against the plan memo the parent carried into ``shard()``;
        an unplanned one is refused (planning needs the single-host index).
        As in the reference, each shard gets only the spec's k, mode,
        n_probes, max_flips and impl: early exit and the screen stay off."""
        from repro_torch.core.distributed import sharded_index_query

        cfg = self.config
        queries = torch.as_tensor(queries)
        weights = torch.as_tensor(weights)
        validate_query_args(cfg.d, queries, weights)
        if isinstance(spec, QualitySpec):
            planned = self.plans.get(spec)
            if planned is None:
                raise ValueError(
                    "ShardedIndex cannot calibrate a new QualitySpec (planning "
                    "needs the single-host index) — call index.plan(quality) "
                    "BEFORE index.shard(mesh), or pass the resolved "
                    "PlannedSpec/QuerySpec explicitly"
                )
            spec = planned
        if isinstance(spec, PlannedSpec):
            cfg = spec.effective_config(cfg)
            spec = spec.to_query_spec()
        if not isinstance(spec, QuerySpec):
            raise TypeError(
                f"spec must be a QuerySpec, QualitySpec, or PlannedSpec; "
                f"got {type(spec).__name__}"
            )
        _check_probe_reach(cfg, spec)
        return sharded_index_query(
            self.index_sharded, queries, weights, cfg, self.mesh, spec=spec,
            merge_hierarchical=self.merge_hierarchical, delta_sharded=self.delta_sharded,
            tombstones_sharded=self.tombstones_sharded,
        )

    def _require_mutable(self, op: str) -> None:
        if not self.mutable:
            raise ValueError(
                f"ShardedIndex.{op}() requires a mutable index — build the "
                f"source Index with update=UpdateSpec(delta_capacity=...) "
                f"before .shard()"
            )

    def insert(self, rows) -> tuple["ShardedIndex", torch.Tensor]:
        """Insert rows across shards, routed round-robin by global id.
        Returns (new sharded index, (m,) int32 global ids; -1 where the
        owning shard's delta is full). The ids are those a single-host
        mutable Index assigns to the same stream."""
        self._require_mutable("insert")
        from repro_torch.core.distributed import sharded_delta_insert

        rows = torch.as_tensor(rows)
        if rows.ndim != 2 or rows.shape[-1] != self.config.d:
            raise ValueError(
                f"insert rows must be (m, d) with trailing dim "
                f"config.d={self.config.d}; got rows.shape={tuple(rows.shape)}"
            )
        deltas, ids = sharded_delta_insert(self.index_sharded, self.delta_sharded, rows,
                                           self.config, self.mesh)
        return dataclasses.replace(self, delta_sharded=deltas), ids

    def delete(self, ids) -> "ShardedIndex":
        """Tombstone global ids on their owning shards (unknown ids ignored)."""
        self._require_mutable("delete")
        from repro_torch.core.distributed import sharded_tombstone

        ts = sharded_tombstone(
            self.tombstones_sharded, ids, [d.fill for d in self.delta_sharded], self.mesh,
            n_local=self.n // self.n_shards, cap=self._cap_local,
        )
        return dataclasses.replace(self, tombstones_sharded=ts)

    def compact(self) -> Index:
        """Gather the surviving rows in global-id order and build a fresh
        single-host sealed :class:`Index` over them on
        ``mesh.devices.flat[0]``, with the shards' tables and mixers, the same
        ``update`` and ``build_key`` — equal, leaf for leaf, to the
        single-host ``Index.compact`` of the same lifecycle. Re-shard it
        explicitly: the survivor count must still divide the mesh."""
        self._require_mutable("compact")
        S, cap = self.n_shards, self._cap_local
        n_local = self.n // S
        dev = self.mesh.devices.flat[0]
        rows = [state.data[~ts[:n_local]].to(dev)
                for state, ts in zip(self.index_sharded, self.tombstones_sharded)]
        if cap:
            # delta gids in insertion order: e -> shard e % S, slot e // S
            data = torch.stack([d.data.to(dev) for d in self.delta_sharded])  # (S, cap, d)
            dead = torch.stack([ts[n_local:].to(dev) for ts in self.tombstones_sharded])
            fills = torch.tensor([d.fill for d in self.delta_sharded], device=dev)
            e = torch.arange(S * cap, device=dev)
            s, t = e % S, e // S
            live = (t < fills[s]) & ~dead[s, t]
            rows.append(data[s[live], t[live]])
        first = self.index_sharded[0]
        state = build_index(None, torch.cat(rows), self.config,
                            tables=first.tables.to(dev), mixers=first.mixers.to(dev))
        return Index(state=state, config=self.config, update=self.update,
                     build_key=self.build_key)
