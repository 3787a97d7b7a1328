"""Candidate sources — counterpart of ``repro.engine.sources``.

A :class:`CandidateSource` turns one query batch into a fixed-shape
``(b, P_src)`` int32 block of GLOBAL row ids: main rows keep their build
ids ``[0, n_main)``, delta slot ``s`` is ``n_main + s``, and entries
``>= n_valid`` (the engine's addressable row count, main plus delta
capacity) are empty slots, so blocks of different sources concatenate
without translation. Three sources cover the query surface:

  * :class:`SortedTableSource` — the sealed segment: the searchsorted
    window probe of the L sorted key columns; with tombstones it masks
    window padding and deleted rows to the sentinel before the block leaves;
  * :class:`DeltaMatchSource` — the delta segment: the chunked key match
    (``core.index._delta_candidates``);
  * :class:`ExhaustiveSource` — every live row, ascending, sentinels last:
    the exact mode of a mutable index as a source.

``pre_deduped`` declares that a block already holds ascending unique ids
with the sentinels packed last, so the tail skips its dedupe.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Protocol

import torch

from repro_torch.core.index import (
    _delta_candidates,
    _mask_dead,
    _probe_one_table,
    delta_live_mask,
)

if TYPE_CHECKING:
    from repro_torch.core.index import ALSHIndex, DeltaSegment, IndexConfig


class CandidateSource(Protocol):
    """Turns a query batch into a fixed-shape block of global row ids."""

    pre_deduped: bool

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """(b, d) queries/weights -> (b, P_src) int32 candidate ids."""
        ...


class SortedTableSource:
    """Sealed-segment source: bounded sorted-window probe of every
    (table, probe key) pair. ``keys`` is the (b, L, P) probing sequence.
    With ``tombstones``, window ids are masked to ``sentinel`` before they
    leave the source — the window padding ``n_main + C`` too, which would
    otherwise name a delta slot as soon as the capacity exceeds C."""

    pre_deduped = False

    def __init__(
        self,
        state: "ALSHIndex",
        cfg: "IndexConfig",
        keys: torch.Tensor,
        tombstones: torch.Tensor | None = None,
        sentinel: int | None = None,
    ):
        self.state = state
        self.cfg = cfg
        self.keys = keys
        self.tombstones = tombstones
        self.sentinel = sentinel

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        b, L, P = self.keys.shape
        C = self.cfg.max_candidates
        keys_lm = self.keys.permute(1, 0, 2).reshape(L, b * P)  # (L, b·P)
        cand = _probe_one_table(self.state.sorted_keys, self.state.perm, keys_lm, C)
        # (L, b, P, C) -> (b, L·P·C): the reference's enumeration order
        cand = cand.reshape(L, b, P, C).permute(1, 0, 2, 3).reshape(b, L * P * C)
        if self.tombstones is not None:
            cand = _mask_dead(cand, self.tombstones, self.state.n, self.sentinel)
        return cand


class DeltaMatchSource:
    """Delta-segment source: a slot is a candidate iff its stored key equals
    one of the query's probe keys in the same table, so one key enumeration
    serves both segments."""

    pre_deduped = False

    def __init__(
        self,
        delta: "DeltaSegment",
        keys: torch.Tensor,
        live: torch.Tensor,
        n_main: int,
        sentinel: int,
    ):
        self.delta = delta
        self.keys = keys
        self.live = live
        self.n_main = n_main
        self.sentinel = sentinel

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        return _delta_candidates(self.keys, self.delta, self.live, self.n_main, self.sentinel)


class ExhaustiveSource:
    """Every live row as a candidate — the exact oracle of a mutable index
    as a source, so the ground truth runs the tail it validates. Emits the
    ascending live ids with the sentinel ``n_main + cap`` packed last."""

    pre_deduped = True

    def __init__(
        self,
        state: "ALSHIndex",
        delta: "DeltaSegment | None",
        tombstones: torch.Tensor,
    ):
        n_main = state.n
        cap = delta.capacity if delta is not None else 0
        n_tot = n_main + cap
        live = ~tombstones[:n_main]
        if cap:
            live = torch.cat([live, delta_live_mask(delta, tombstones, n_main)])
        ids = torch.arange(n_tot, dtype=torch.int32, device=tombstones.device)
        self.ids_row = torch.sort(torch.where(live, ids, torch.full_like(ids, n_tot))).values

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        b = queries.shape[0]
        # materialized: the kernels take contiguous ids (b·(n_main + cap) int32)
        return self.ids_row[None, :].expand(b, -1).contiguous()
