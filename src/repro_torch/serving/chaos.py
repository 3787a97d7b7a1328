"""Shard fault injection and degraded-coverage answering for serving —
counterpart of ``repro.serving.chaos``.

The serving tier's distribution unit is the :class:`ShardSet`: one
single-device :class:`~repro_torch.api.index.Index` per contiguous row
range (``shard_row_ranges``), every one hashing with the parent's tables
and mixers — so a query's keys are valid against every shard and a shard's
local id plus its range offset is the global id. Each member is an
independently killable and recoverable process stand-in, which is what a
chaos drill needs:

  * ``arm_failure(s)`` makes shard ``s`` raise ``SimulatedFailure`` from
    its next query — the death happens MID-STREAM, inside a batch that
    other shards answer.
  * a dead shard contributes a full sentinel block (``ids == -1``,
    ``dists == +inf``) to the host merge; the response carries
    ``coverage = live/S`` so a survivors-only answer is labeled, never
    silent.
  * recovery reloads the lost shard from its persisted directory (written
    at build time) under a capped exponential backoff in the broker's
    virtual clock, with the first ``recovery_failures`` attempts injected
    to fail — exercising the retry path, not just the happy one.
    Deterministic save/load + the stable host merge make post-recovery
    answers bit-identical to pre-failure ones.

Where the port differs from the reference: the reference rebuilds each
shard from the parent's ``build_key`` (``Index.build(build_key, ...)``),
which replays its JAX random draws. The port cannot replay a key, so each
shard is built from the parent's ``PrefixTables`` and mixers themselves
(``build_index(..., tables=, mixers=)``) — the same tables either way — and
carries the parent's ``build_key`` as opaque bytes. Only the main segment
of a mutable parent is sharded (its delta rows and tombstones are not), as
in the reference.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import quant
from repro_torch.api.index import Index
from repro_torch.core.distributed import merge_topk_host, shard_row_ranges
from repro_torch.core.index import build_index
from repro_torch.runtime.fault import SimulatedFailure


@dataclass(frozen=True)
class ChaosPlan:
    """One scripted shard failure + its recovery policy.

    ``kill_at_s`` is in the broker's virtual clock; the kill is armed when
    the clock passes it, so the shard dies inside whatever batch is in
    flight. The first ``recovery_failures`` reload attempts are injected
    to fail, each pushing the next attempt out by
    ``min(backoff_base_s · 2^i, backoff_cap_s)``.
    """

    kill_shard: int = 0
    kill_at_s: float = 0.0
    recovery_failures: int = 2
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 1.0


class ShardSetResult(NamedTuple):
    dists: np.ndarray  # (b, k) float64 ascending; +inf sentinels
    ids: np.ndarray  # (b, k) int64 GLOBAL row ids; -1 sentinels
    n_candidates: np.ndarray  # (b,) int64 summed over live shards
    coverage: float  # live_shards / n_shards at answer time


@dataclass
class ShardSet:
    """Host-side set of per-range indexes with kill/recover lifecycle.

    ``device`` is where a recovered shard is loaded (the device the set was
    built on; None means the CUDA card, as ``Index.load`` defaults)."""

    shards: list  # Optional[Index] per slot; None while dead
    offsets: list  # global row offset per shard
    dirs: list  # persisted directory per shard (the recovery source)
    n_rows: int
    device: Optional[torch.device] = None
    chaos: Optional[ChaosPlan] = None
    recovery_log: list = field(default_factory=list)
    _armed: list = field(default_factory=list)
    _chaos_fired: bool = False
    _recover_attempts: dict = field(default_factory=dict)
    _next_attempt_s: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self._armed:
            self._armed = [False] * len(self.shards)

    @classmethod
    def build(cls, index: Index, n_shards: int, root: str) -> "ShardSet":
        """Split ``index``'s main rows into contiguous shards, build each
        with the parent's tables and mixers (a shard's local id plus its
        range offset IS the global id), persist every shard under
        ``root/shard_<s>`` for later recovery, and serve the loaded copies
        on the parent's device."""
        ranges = shard_row_ranges(index.n, n_shards)
        # decode quantized payloads back to f32 rows: build_index re-encodes
        # each shard with its own scales, so every shard is self-consistent
        data = quant.decode_table(index.state.data, index.state.scales)
        tables, mixers = index.state.tables, index.state.mixers
        shards, offsets, dirs = [], [], []
        for s, (lo, hi) in enumerate(ranges):
            state = build_index(None, data[lo:hi], index.config, tables=tables, mixers=mixers)
            shard = Index(state=state, config=index.config, build_key=index.build_key)
            d = os.path.join(root, f"shard_{s}")
            shard.save(d)
            # serve the LOADED artifact, not the freshly-built object: a
            # recovered shard is then tensor-for-tensor the one it replaces
            shards.append(Index.load(d, device=index.device))
            offsets.append(lo)
            dirs.append(d)
        return cls(shards=shards, offsets=offsets, dirs=dirs, n_rows=index.n,
                   device=index.device)

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    @property
    def live(self) -> list:
        return [s is not None for s in self.shards]

    @property
    def coverage(self) -> float:
        return sum(self.live) / self.n_shards

    # -- failure injection ---------------------------------------------------
    def arm_failure(self, s: int) -> None:
        """Next query touching shard ``s`` raises SimulatedFailure (caught
        by ``query`` — the shard dies, the batch is answered by survivors)."""
        self._armed[s] = True

    def _on_death(self, s: int, now_s: float) -> None:
        self.shards[s] = None
        self._recover_attempts[s] = 0
        self._next_attempt_s[s] = now_s + (
            self.chaos.backoff_base_s if self.chaos else 0.05
        )
        self.recovery_log.append(
            {"t_s": now_s, "shard": s, "event": "killed"}
        )

    def tick(self, now_s: float) -> None:
        """Advance the chaos script to virtual time ``now_s``: fire the
        scripted kill once the clock passes ``kill_at_s``, and run due
        recovery attempts (with injected failures + capped exponential
        backoff) for every dead shard."""
        if (
            self.chaos is not None
            and not self._chaos_fired
            and now_s >= self.chaos.kill_at_s
        ):
            self._chaos_fired = True
            self.arm_failure(self.chaos.kill_shard)
        for s in range(self.n_shards):
            if self.shards[s] is None and now_s >= self._next_attempt_s.get(
                s, float("inf")
            ):
                self._attempt_recovery(s, now_s)

    def _attempt_recovery(self, s: int, now_s: float) -> None:
        plan = self.chaos or ChaosPlan(kill_shard=s)
        i = self._recover_attempts[s]
        self._recover_attempts[s] = i + 1
        backoff = min(plan.backoff_base_s * 2.0**i, plan.backoff_cap_s)
        try:
            if i < plan.recovery_failures:
                raise SimulatedFailure(
                    f"injected recovery failure {i + 1}/{plan.recovery_failures} "
                    f"for shard {s}"
                )
            self.shards[s] = Index.load(self.dirs[s], device=self.device)
        except SimulatedFailure as e:
            self._next_attempt_s[s] = now_s + backoff
            self.recovery_log.append(
                {
                    "t_s": now_s,
                    "shard": s,
                    "event": "recover_failed",
                    "attempt": i + 1,
                    "next_backoff_s": backoff,
                    "error": str(e),
                }
            )
        else:
            del self._next_attempt_s[s]
            self.recovery_log.append(
                {"t_s": now_s, "shard": s, "event": "recovered", "attempt": i + 1}
            )

    def recover_now(self, s: int) -> None:
        """Unconditional reload (tests / manual ops)."""
        self.shards[s] = Index.load(self.dirs[s], device=self.device)
        self._next_attempt_s.pop(s, None)

    # -- querying ------------------------------------------------------------
    def query(self, queries, weights, spec, now_s: float = 0.0) -> ShardSetResult:
        """Fan a batch over the live shards and host-merge to global top-k.

        Pass the resolved :class:`~repro_torch.api.spec.PlannedSpec` (or a
        raw QuerySpec) — a QualitySpec would trigger a per-shard
        calibration. An armed failure raises from its shard's query and is
        caught HERE: the shard is marked dead mid-batch and the remaining
        shards still answer, with ``coverage`` reflecting the loss. Every
        shard's answer is copied to the host, which waits for the device.
        """
        blocks_d, blocks_i, n_cand = [], [], None
        b = queries.shape[0]
        k = spec.k
        sent_d = np.full((b, k), np.inf)
        sent_i = np.full((b, k), -1, dtype=np.int64)
        for s in range(self.n_shards):
            if self.shards[s] is None:
                blocks_d.append(sent_d)
                blocks_i.append(sent_i)
                continue
            try:
                if self._armed[s]:
                    self._armed[s] = False
                    raise SimulatedFailure(f"shard {s} killed mid-stream")
                res = self.shards[s].query(queries, weights, spec)
            except SimulatedFailure:
                self._on_death(s, now_s)
                blocks_d.append(sent_d)
                blocks_i.append(sent_i)
                continue
            ids = res.ids.cpu().numpy().astype(np.int64)
            blocks_d.append(res.dists.cpu().numpy().astype(np.float64))
            blocks_i.append(np.where(ids >= 0, ids + self.offsets[s], -1))
            nc = res.n_candidates.cpu().numpy().astype(np.int64)
            n_cand = nc if n_cand is None else n_cand + nc
        if n_cand is None:
            n_cand = np.zeros((b,), np.int64)
        dists, ids = merge_topk_host(np.stack(blocks_d), np.stack(blocks_i), k)
        return ShardSetResult(dists, ids, n_cand, self.coverage)
