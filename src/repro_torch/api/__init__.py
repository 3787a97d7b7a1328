"""The public facade: ``Index`` and the specs."""

from repro_torch.api.index import Index, validate_query_args
from repro_torch.api.planner import Planner, QueryReport
from repro_torch.api.spec import PlannedSpec, QualitySpec, QuerySpec, UpdateSpec
from repro_torch.core.families import (
    FAMILIES,
    HashFamily,
    L2Family,
    ThetaFamily,
    get_family,
)
from repro_torch.core.index import DeltaSegment, IndexConfig, QueryResult
from repro_torch.core.transforms import BoundedSpace

# The reference's names but ShardedIndex (ROADMAP Queue A item 12), and
# validate_query_args, which the port also exports here.
__all__ = [
    "BoundedSpace",
    "DeltaSegment",
    "FAMILIES",
    "HashFamily",
    "Index",
    "IndexConfig",
    "L2Family",
    "PlannedSpec",
    "Planner",
    "QualitySpec",
    "QueryReport",
    "QueryResult",
    "QuerySpec",
    "ThetaFamily",
    "UpdateSpec",
    "get_family",
    "validate_query_args",
]
