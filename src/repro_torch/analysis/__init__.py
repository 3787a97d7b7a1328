"""Static and runtime contracts of the port. So far only the rebuild guard
(``retrace_guard``); the rest of the reference's ``analysis/`` is ROADMAP
Queue A item 13."""

from repro_torch.analysis.retrace_guard import RetraceError, RetraceGuard, library_loads

__all__ = ["RetraceError", "RetraceGuard", "library_loads"]
