"""The static-contract gate of the port — counterpart of ``repro.analysis``.

Two layers, one verdict (``python -m repro_torch.analysis`` exits non-zero
on any finding):

  * :mod:`repro_torch.analysis.lint` — an AST pass over ``src/repro_torch``
    with the reference's stable RPR0xx codes in their torch meaning (tensor
    branches, host syncs on the hot path, sentinel fills, memo hygiene,
    import-time tensors, kernel confinement, private build pokes).
    Violations are silenced only by an inline ``# repro: allow[RPRxxx]
    <reason>`` with a non-empty reason.
  * :mod:`repro_torch.analysis.audit` — EXECUTES the public query
    entry-point lattice once per point (the reference traces it) and checks
    the budgets of :mod:`repro_torch.analysis.budgets`: compile-key
    cardinality (AUD002), peak live bytes (AUD001), dtype contracts
    (AUD003), and drift against the backend's golden (AUD004).

:mod:`repro_torch.analysis.retrace_guard` is the live counterpart of the
retrace contract: the port has no jit cache, so it watches the kernel
libraries built or loaded (``kernels._build.library_loads``).
"""

from __future__ import annotations

from repro_torch.analysis.lint import Finding, lint_paths, lint_source
from repro_torch.analysis.retrace_guard import RetraceError, RetraceGuard, library_loads


def engine_cache_size() -> int:
    """The port's counterpart of the reference's engine jit-cache size: the
    kernel libraries built or loaded in this process
    (``kernels._build.library_loads``), the one count a served request can
    grow. Every engine path shares those libraries."""
    return library_loads()


def cache_size(fn=None) -> int:
    """The watched count: ``fn()`` when a counting callable is given (what
    ``RetraceGuard(fn=...)`` watches), else :func:`library_loads`."""
    return library_loads() if fn is None else fn()


__all__ = [
    "Finding",
    "lint_paths",
    "lint_source",
    "RetraceError",
    "RetraceGuard",
    "cache_size",
    "engine_cache_size",
    "library_loads",
]
