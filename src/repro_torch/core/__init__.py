"""Data structures and primitives of the port (transforms, hash families,
the sealed index)."""

from repro_torch.core.hash_families import LSHParams, PrefixTables, make_prefix_tables
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    build_index,
    index_from_numpy,
)
from repro_torch.core.transforms import (
    BoundedSpace,
    discretization_slack,
    discretize,
    transform_P,
    transform_Q,
    unary_code,
    wl1_via_mips,
)

__all__ = [
    "ALSHIndex",
    "BoundedSpace",
    "DeltaSegment",
    "IndexConfig",
    "LSHParams",
    "PrefixTables",
    "QueryResult",
    "build_index",
    "discretization_slack",
    "discretize",
    "index_from_numpy",
    "make_prefix_tables",
    "transform_P",
    "transform_Q",
    "unary_code",
    "wl1_via_mips",
]
