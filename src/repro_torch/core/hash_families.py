"""Paper §4.2: the ALSH families and the O(d) projection trick (§4.2.3).

Counterpart of ``repro.core.hash_families``. Data hash f(x) = h(P(x)), query
hash g(x) = h(Q_w(x)); both need a Gaussian projection over the 2Md-dim
transformed vectors, which §4.2.3 collapses to a lookup in a folded prefix
table b' of shape (H, d, M+1):

    a^T P(o)   = sum_i        b'[h, i, o_i]
    a^T Q_w(q) = sum_i  w_i * b'[h, i, q_i]

The lookup runs in ``repro_torch.kernels.ops.alsh_project`` (the CUDA kernel
on the card, its plain version on the CPU). The query side also takes the
reference's two plain formulations, ``impl="gather"`` (per-coordinate
gather + reduce, the plain version of ``ops.alsh_project``) and ``impl="onehot"`` (a one-hot contraction), on CPU
tensors only: on the card the kernel is the one projection.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core.families import get_family
from repro_torch.kernels import ops
from repro_torch.kernels.alsh_project import tile_folded

__all__ = [
    "LSHParams",
    "PrefixTables",
    "make_prefix_tables",
    "naive_projection_vector",
    "project_data",
    "project_query",
    "l2_hash",
    "sign_hash",
    "hash_data",
    "hash_query",
]


@dataclasses.dataclass(frozen=True)
class LSHParams:
    """Static configuration of one ALSH family instance (d, M, H = K·L,
    family name, l2 bucket width W)."""

    d: int
    M: int
    n_hashes: int
    family: Literal["l2", "theta"] = "theta"
    W: float = 4.0


@dataclasses.dataclass
class PrefixTables:
    """The folded projection state of §4.2.3.

    folded: (H, d, M+1) — b'[h, i, m] = suffix_cos[h, i, m] + prefix_sin[h, i, m]
    offsets: (H,) — the uniform offset b ~ U[0, W] for l2 (zeros for theta).
    tiled: the CUDA kernel's relayout of ``folded`` (``tile_folded``), made
    once here when ``folded`` lies on the card; None elsewhere.
    """

    folded: torch.Tensor
    offsets: torch.Tensor
    tiled: torch.Tensor | None = dataclasses.field(default=None, init=False, repr=False,
                                                   compare=False)

    def __post_init__(self):
        if self.folded.is_cuda:
            self.tiled = tile_folded(self.folded)

    def to(self, device) -> "PrefixTables":
        """The tables on ``device``; itself when they lie there already (so
        shards built on one card share one table relayout)."""
        folded = self.folded.to(device)
        if folded is self.folded and self.offsets.device == folded.device:
            return self
        return PrefixTables(folded, self.offsets.to(device))


def naive_projection_vector(a_rows: torch.Tensor) -> torch.Tensor:
    """The flat 2Md Gaussian vector ``a`` from its (2d, M) row view, in the
    layout of ``transforms.transform_P``/``transform_Q`` (cos rows 0..d-1,
    then sin rows d..2d-1). Test-only: the naive O(Md) inner product that
    the O(d) trick is checked against."""
    return a_rows.reshape(-1)


def _prefix_tables_from_rows(a_rows: torch.Tensor) -> torch.Tensor:
    """Eq 28 (0-indexed): (..., 2d, M) Gaussian rows -> folded (..., d, M+1).

    Rows 0..d-1 become suffix sums with a trailing 0 column, rows d..2d-1
    prefix sums with a leading 0 column; the two halves are added (folded)
    because data and query share the lookup index.
    """
    d = a_rows.shape[-2] // 2
    cos_rows, sin_rows = a_rows[..., :d, :], a_rows[..., d:, :]
    zeros = a_rows.new_zeros((*a_rows.shape[:-2], d, 1))
    suffix = torch.cat([torch.cumsum(cos_rows.flip(-1), dim=-1).flip(-1), zeros], dim=-1)
    prefix = torch.cat([zeros, torch.cumsum(sin_rows, dim=-1)], dim=-1)
    return suffix + prefix


def make_prefix_tables(
    generator: torch.Generator, params: LSHParams, dtype=torch.float32
) -> PrefixTables:
    """Draw H Gaussian projections from ``generator`` and fold them.

    The draw happens on the generator's device (a CPU generator gives the
    same tables whatever device the index later lives on); callers move the
    result with :meth:`PrefixTables.to`.
    """
    a = torch.randn(
        (params.n_hashes, 2 * params.d, params.M), generator=generator, dtype=dtype
    )
    offsets = get_family(params.family).make_offsets(generator, params.n_hashes, params.W, dtype)
    return PrefixTables(folded=_prefix_tables_from_rows(a), offsets=offsets)


def project_data(levels: torch.Tensor, tables: PrefixTables) -> torch.Tensor:
    """a^T P(o) for a batch of lattice points: (n, d) int32 -> (n, H) f32."""
    return ops.alsh_project(levels, tables.folded, weights=None, tiled=tables.tiled)


def project_query(
    levels: torch.Tensor, w: torch.Tensor, tables: PrefixTables, impl: str = "auto"
) -> torch.Tensor:
    """a^T Q_w(q): the asymmetric (weighted) projection, (b, d) -> (b, H).
    ``impl`` "auto" runs ``ops.alsh_project``; "gather" and "onehot" run the
    reference's plain formulations and raise on a CUDA tensor."""
    if impl == "auto":
        return ops.alsh_project(levels, tables.folded, weights=w, tiled=tables.tiled)
    if levels.device.type != "cpu":
        raise ValueError(
            f"impl={impl!r} selects a plain projection, which runs on CPU tensors only; "
            f"on {levels.device} the query projection is the alsh_project kernel "
            f"(impl='auto')"
        )
    if impl == "onehot":
        return _project_onehot(levels, tables.folded, w)
    # On a CPU tensor ops.alsh_project is the plain gather + reduce.
    return ops.alsh_project(levels, tables.folded, weights=w)


def _project_onehot(levels, folded, weights):
    """The one-hot contraction: (n, d·(M+1)) @ (d·(M+1), H)."""
    M1 = folded.shape[-1]
    onehot = torch.nn.functional.one_hot(levels.long(), M1).to(folded.dtype)  # (n, d, M+1)
    if weights is not None:
        onehot = onehot * weights[..., None]
    lhs = onehot.reshape(levels.shape[0], -1)
    rhs = folded.permute(1, 2, 0).reshape(-1, folded.shape[0])
    return lhs @ rhs


def l2_hash(projections: torch.Tensor, tables: PrefixTables, W: float) -> torch.Tensor:
    """Eq 3: h(x) = floor((a^T x + b) / W), integer bucket codes."""
    return get_family("l2").codes_from_projections(projections, tables.offsets, W)


def sign_hash(projections: torch.Tensor) -> torch.Tensor:
    """Eq 5: h(x) = 1[a^T x >= 0], SimHash bits."""
    return get_family("theta").codes_from_projections(projections, None, 0.0)


def hash_data(levels: torch.Tensor, tables: PrefixTables, params: LSHParams) -> torch.Tensor:
    """f(o) = h(P(o)) for a batch: (n, d) -> (n, H) int32 codes."""
    proj = project_data(levels, tables)
    return get_family(params.family).codes_from_projections(proj, tables.offsets, params.W)


def hash_query(
    levels: torch.Tensor, w: torch.Tensor, tables: PrefixTables, params: LSHParams,
    impl: str = "auto",
) -> torch.Tensor:
    """g(q) = h(Q_w(q)) for a batch: (b, d) + (b, d) weights -> (b, H) int32."""
    proj = project_query(levels, w, tables, impl=impl)
    return get_family(params.family).codes_from_projections(proj, tables.offsets, params.W)
