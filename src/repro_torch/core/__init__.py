"""Data structures and primitives of the port — counterpart of
``repro.core``.

  transforms     — Obs 1 discretization, unary coding, P / Q_w maps (Eq 19-21)
  families       — hash families as pluggable strategy objects (theta, l2)
  hash_families  — L2-LSH + SimHash with the §4.2.3 O(d) projection trick
  theory         — Eq 4/6/25/27 collision probabilities, rho, (K, L) planning
  index          — Theorem-1 multi-table index (sorted-key tables, window probes)
  multiprobe     — probe perturbation sequences (fewer tables)

Query execution is :mod:`repro_torch.engine`; ``repro_torch.api`` is the
facade consumers should use. As in the reference, ``build_index`` /
``query_index`` / ``query_multiprobe`` stay importable from here as thin
shims over the engine, DEPRECATED: calling the package-level names emits a
``DeprecationWarning`` pointing at ``repro_torch.api.Index``. The defining
modules ``repro_torch.core.index`` / ``repro_torch.core.multiprobe`` stay
warning-free, and the port's own code imports from them.
"""

import functools as _functools
import warnings as _warnings

from repro_torch.core.families import (
    FAMILIES,
    HashFamily,
    L2Family,
    ThetaFamily,
    get_family,
)
from repro_torch.core.hash_families import (
    LSHParams,
    PrefixTables,
    hash_data,
    hash_query,
    make_prefix_tables,
    project_data,
    project_query,
)
from repro_torch.core.index import (
    ALSHIndex,
    DeltaSegment,
    IndexConfig,
    QueryResult,
    delta_insert,
    index_from_numpy,
    query_index_segmented,
    tombstone_ids,
)
from repro_torch.core.index import build_index as _build_index
from repro_torch.core.index import query_index as _query_index
from repro_torch.core.multiprobe import query_multiprobe as _query_multiprobe
from repro_torch.core.theory import (
    IndexPlan,
    collision_prob_l2,
    collision_prob_theta,
    plan_index,
    rho,
    success_probability,
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


def _deprecated_shim(fn, name: str, facade: str):
    @_functools.wraps(fn)
    def shim(*args, **kwargs):
        _warnings.warn(
            f"repro_torch.core.{name} is a legacy shim — use {facade} instead "
            f"(one config-carrying Index; same engine, same results)",
            DeprecationWarning,
            stacklevel=2,
        )
        return fn(*args, **kwargs)

    return shim


build_index = _deprecated_shim(
    _build_index, "build_index", "repro_torch.api.Index.build"
)
query_index = _deprecated_shim(
    _query_index, "query_index", "repro_torch.api.Index.query"
)
query_multiprobe = _deprecated_shim(
    _query_multiprobe,
    "query_multiprobe",
    "repro_torch.api.Index.query with QuerySpec(mode='multiprobe')",
)

__all__ = [
    "FAMILIES",
    "HashFamily",
    "L2Family",
    "ThetaFamily",
    "get_family",
    "BoundedSpace",
    "discretize",
    "discretization_slack",
    "transform_P",
    "transform_Q",
    "unary_code",
    "wl1_via_mips",
    "LSHParams",
    "PrefixTables",
    "hash_data",
    "hash_query",
    "make_prefix_tables",
    "project_data",
    "project_query",
    "IndexPlan",
    "collision_prob_l2",
    "collision_prob_theta",
    "plan_index",
    "rho",
    "success_probability",
    "ALSHIndex",
    "DeltaSegment",
    "IndexConfig",
    "QueryResult",
    "build_index",
    "delta_insert",
    "index_from_numpy",
    "query_index",
    "query_index_segmented",
    "query_multiprobe",
    "tombstone_ids",
]
