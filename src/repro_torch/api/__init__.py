"""The public facade: ``Index`` and the specs."""

from repro_torch.api.index import Index, validate_query_args
from repro_torch.api.planner import Planner, QueryReport
from repro_torch.api.spec import PlannedSpec, QualitySpec, QuerySpec, UpdateSpec
from repro_torch.core.index import IndexConfig, QueryResult
from repro_torch.core.transforms import BoundedSpace

__all__ = [
    "BoundedSpace",
    "Index",
    "IndexConfig",
    "PlannedSpec",
    "Planner",
    "QualitySpec",
    "QueryReport",
    "QueryResult",
    "QuerySpec",
    "UpdateSpec",
    "validate_query_args",
]
