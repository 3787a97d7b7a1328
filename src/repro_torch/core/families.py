"""Hash families as strategy objects — counterpart of ``repro.core.families``.

  * :class:`ThetaFamily` — (d_w^l1, theta)-ALSH, Eq 5 SimHash sign bits,
    exact bit-packed int32 keys (K <= 31).
  * :class:`L2Family` — (d_w^l1, l2)-ALSH, Eq 3 p-stable integer codes,
    combined by wrapping int32 multiply-add with odd mixers.

Instances are stateless singletons. Query-directed multiprobe
(``multiprobe_keys``) is theta-only; ``flip_subsets`` enumerates its bit
flips and ``n_flip_subsets`` counts them.
"""

from __future__ import annotations

import itertools
import math
from typing import TYPE_CHECKING

import torch

from repro_torch.kernels import ops

if TYPE_CHECKING:
    from repro_torch.core.index import IndexConfig

__all__ = [
    "HashFamily",
    "ThetaFamily",
    "L2Family",
    "THETA",
    "L2",
    "FAMILIES",
    "get_family",
    "flip_subsets",
    "n_flip_subsets",
]

_U32 = 1 << 32


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Reduce an int64 tensor mod 2**32 and reinterpret it as int32 — the
    two's-complement wraparound the reference's int32 arithmetic has."""
    x = torch.remainder(x, _U32)
    return torch.where(x >= (1 << 31), x - _U32, x).to(torch.int32)


class HashFamily:
    """Protocol (with shared behavior) for one ALSH hash family."""

    name: str = "abstract"
    supports_multiprobe: bool = False
    max_K: int | None = None  # per-table hash cap (None = unbounded)

    def validate(self, cfg: "IndexConfig") -> None:
        """Raise ValueError (naming the offending field) on bad geometry."""

    def make_offsets(
        self, generator: torch.Generator, n_hashes: int, W: float, dtype=torch.float32
    ) -> torch.Tensor:
        """Per-hash offsets drawn at table-build time ((H,) CPU tensor)."""
        raise NotImplementedError

    def codes_from_projections(
        self, proj: torch.Tensor, offsets: torch.Tensor, W: float
    ) -> torch.Tensor:
        """(..., H) float projections -> (..., H) int32 hash codes."""
        raise NotImplementedError

    def combine_codes(self, codes_lk: torch.Tensor, mixers: torch.Tensor, K: int) -> torch.Tensor:
        """(..., L, K) int codes -> (..., L) int32 table keys."""
        raise NotImplementedError

    def multiprobe_keys(
        self, proj_lk: torch.Tensor, n_probes: int, max_flips: int
    ) -> torch.Tensor:
        """(b, L, K) raw projections -> (b, L, P) probe keys, most-likely first."""
        raise NotImplementedError(
            f"family {self.name!r} does not support multiprobe querying; "
            "use the 'theta' family or QuerySpec(mode='probe')"
        )


class ThetaFamily(HashFamily):
    """(d_w^l1, theta)-ALSH — Eq 5 SimHash sign bits, exact bit-packed keys."""

    name = "theta"
    supports_multiprobe = True
    max_K = 31  # int32 bit-packing limit

    def validate(self, cfg: "IndexConfig") -> None:
        if cfg.K > 31:
            raise ValueError(
                "IndexConfig.K: the theta family packs K sign bits into one "
                f"int32 table key, which requires K <= 31 (got K={cfg.K}); "
                "use more tables (L) or the 'l2' family instead"
            )

    def make_offsets(self, generator, n_hashes, W, dtype=torch.float32):
        return torch.zeros((n_hashes,), dtype=dtype)  # sign hash has no offset

    def codes_from_projections(self, proj, offsets, W):
        return (proj >= 0).to(torch.int32)  # Eq 5

    def combine_codes(self, codes_lk, mixers, K):
        # exact bit-packing: K <= 31 bits, so the int64 sum fits int32 exactly
        shifts = torch.ones((), dtype=torch.int64, device=codes_lk.device) << torch.arange(
            K, dtype=torch.int64, device=codes_lk.device
        )
        return torch.sum(codes_lk.to(torch.int64) * shifts, dim=-1).to(torch.int32)

    def multiprobe_keys(self, proj_lk, n_probes, max_flips):
        """Query-directed probing (Lv et al., VLDB'07): probe the buckets
        whose keys flip the lowest-|margin| bits of the query's code, in
        increasing total flipped margin. Ties go to the earlier subset in
        ``flip_subsets`` order (a stable sort, as ``lax.top_k`` breaks them).
        On the card one kernel enumerates the subsets; on the CPU the plain
        version scores the ``flip_subsets`` table (``kernels.ops``)."""
        return ops.multiprobe_keys(proj_lk, n_probes, max_flips)


class L2Family(HashFamily):
    """(d_w^l1, l2)-ALSH — Eq 3 p-stable hash, mixed integer-code keys."""

    name = "l2"

    def validate(self, cfg: "IndexConfig") -> None:
        if cfg.W <= 0:
            raise ValueError(
                f"IndexConfig.W: the l2 family's bucket width must be > 0, got {cfg.W}"
            )

    def make_offsets(self, generator, n_hashes, W, dtype=torch.float32):
        return torch.rand((n_hashes,), generator=generator, dtype=dtype) * W

    def codes_from_projections(self, proj, offsets, W):
        return torch.floor((proj + offsets[None, :]) / W).to(torch.int32)  # Eq 3

    def combine_codes(self, codes_lk, mixers, K):
        # The reference multiplies and sums in int32 and relies on wraparound;
        # torch.sum of int32 promotes to int64, so wrap each product and the
        # sum mod 2**32 explicitly (|product| < 2**62, K * 2**32 fits int64).
        prod = torch.remainder(codes_lk.to(torch.int64) * mixers.to(torch.int64), _U32)
        return _wrap_int32(torch.sum(prod, dim=-1))


def n_flip_subsets(K: int, max_flips: int) -> int:
    """How many distinct probe keys ``flip_subsets`` can reach: the number
    of bit-flip subsets of size <= max_flips, INCLUDING the empty subset
    (the query's own bucket)."""
    return sum(math.comb(K, r) for r in range(0, min(max_flips, K) + 1))


def flip_subsets(K: int, max_flips: int, device=None) -> torch.Tensor:
    """Static enumeration of bit-flip subsets as (n_subsets, K) bool masks,
    ordered by size, then lexicographically (``itertools.combinations``)."""
    subsets = [()]
    for r in range(1, max_flips + 1):
        subsets.extend(itertools.combinations(range(K), r))
    masks = torch.zeros((len(subsets), K), dtype=torch.bool)
    for i, s in enumerate(subsets):
        masks[i, list(s)] = True
    return masks.to(device)


THETA = ThetaFamily()
L2 = L2Family()
FAMILIES: dict[str, HashFamily] = {f.name: f for f in (THETA, L2)}


def get_family(name) -> HashFamily:
    """Resolve a family by name (or pass a strategy object through)."""
    if isinstance(name, HashFamily):
        return name
    fam = FAMILIES.get(name)
    if fam is None:
        raise ValueError(f"unknown hash family {name!r}; known families: {sorted(FAMILIES)}")
    return fam
