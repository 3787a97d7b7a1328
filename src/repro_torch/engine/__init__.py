"""The shared execution pipeline (key enumeration → sources → one tail)."""

from repro_torch.engine.pipeline import dispatch, execute, probe_keys, query, sources_for
from repro_torch.engine.sources import (
    CandidateSource,
    DeltaMatchSource,
    ExhaustiveSource,
    SortedTableSource,
)

__all__ = [
    "CandidateSource",
    "DeltaMatchSource",
    "ExhaustiveSource",
    "SortedTableSource",
    "dispatch",
    "execute",
    "probe_keys",
    "query",
    "sources_for",
]
