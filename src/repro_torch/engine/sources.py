"""Candidate sources — counterpart of ``repro.engine.sources``.

A :class:`CandidateSource` turns one query batch into a fixed-shape
``(b, P_src)`` int32 block of global row ids; entries ``>= n_valid`` are
empty slots. Only the sealed-segment source is ported:
:class:`SortedTableSource`, the searchsorted window probe of the L sorted
key columns (no tombstones). ``DeltaMatchSource`` and ``ExhaustiveSource``
come with the mutable lifecycle (ROADMAP.md Queue A item 7).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Protocol

import torch

from repro_torch.core.index import _probe_one_table

if TYPE_CHECKING:
    from repro_torch.core.index import ALSHIndex, IndexConfig


class CandidateSource(Protocol):
    """Turns a query batch into a fixed-shape block of global row ids."""

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        """(b, d) queries/weights -> (b, P_src) int32 candidate ids."""
        ...


class SortedTableSource:
    """Sealed-segment source: bounded sorted-window probe of every
    (table, probe key) pair. ``keys`` is the (b, L, P) probing sequence."""

    def __init__(self, state: "ALSHIndex", cfg: "IndexConfig", keys: torch.Tensor):
        self.state = state
        self.cfg = cfg
        self.keys = keys

    def emit(self, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        b, L, P = self.keys.shape
        C = self.cfg.max_candidates
        keys_lm = self.keys.permute(1, 0, 2).reshape(L, b * P)  # (L, b·P)
        cand = _probe_one_table(self.state.sorted_keys, self.state.perm, keys_lm, C)
        # (L, b, P, C) -> (b, L·P·C): the reference's enumeration order
        return cand.reshape(L, b, P, C).permute(1, 0, 2, 3).reshape(b, L * P * C)
