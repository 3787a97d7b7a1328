"""The shared execution pipeline (key enumeration → sources → one tail:
the monolithic ``execute`` or the streamed early-exit ``execute_streamed``)."""

from repro_torch.engine.pipeline import (
    dispatch,
    execute,
    execute_streamed,
    probe_keys,
    query,
    sources_for,
)
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
    "execute_streamed",
    "probe_keys",
    "query",
    "sources_for",
]
