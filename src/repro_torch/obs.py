"""Stage spans of the query path, recorded only while a ``torch.profiler``
session records.

``span(name)`` marks a stretch of host code as ``repro_torch.<name>``: a
``torch.profiler.record_function`` while a profiler records, so the span is
a host event of the same trace as the device activity and on its clock;
otherwise one shared no-op context manager, after a check that costs well
under a microsecond. ``stage(name, device)`` is a span that, on a CUDA
device, also records a pair of timing events at its two ends; ``stage_ms()``
resolves them after the fact: per stage, the milliseconds from the stream
reaching the stage to its last operation done, and the number of calls.

The package keeps no timestamps of its own and writes nothing: the profiler
holds the spans and its caller exports them. The event pairs belong to the
latest profiling session: the first stage recorded after a span that ran
with no profiler drops the pairs recorded before it.

Any profiler session around the calls turns the spans on, for example::

    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        index.query(queries, weights, spec)
    print(obs.stage_ms())
"""

from __future__ import annotations

import contextlib

import torch

PREFIX = "repro_torch."

# the C++ profiler state: also true for a session started outside Python
_recording = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_pending: list = []  # (stage, start event, end event) not resolved yet
_totals: dict[str, list] = {}  # stage -> [total ms, calls]
_stale = False  # a span ran with no profiler since the last recorded stage


def span(name: str):
    """A context manager around ``repro_torch.<name>``: a profiler span while
    a profiler records, the shared no-op otherwise."""
    global _stale
    if not _recording():
        _stale = True
        return _NOOP
    return torch.profiler.record_function(PREFIX + name)


def stage(name: str, device: torch.device):
    """``span(name)`` that, on a CUDA ``device`` while a profiler records,
    also times the stage on the device's current stream."""
    global _stale
    if not _recording():
        _stale = True
        return _NOOP
    if device.type != "cuda":
        return torch.profiler.record_function(PREFIX + name)
    if _stale:
        _pending.clear()
        _totals.clear()
        _stale = False
    return _TimedStage(name)


class _TimedStage:
    """A profiler span with a timing event recorded just inside each end."""

    __slots__ = ("name", "span", "start", "end")

    def __init__(self, name: str):
        self.name = name
        self.span = torch.profiler.record_function(PREFIX + name)
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self.span.__enter__()
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        _pending.append((self.name, self.start, self.end))
        return self.span.__exit__(*exc)


def stage_ms() -> dict[str, tuple[float, int]]:
    """``{stage: (total ms, calls)}`` of the latest profiling session's
    timed stages. Waits for the device to finish the pairs not resolved
    yet, so call it after the measured stretch, not inside it."""
    waiting = _pending[:]
    del _pending[: len(waiting)]  # keep pairs another thread appends meanwhile
    for name, start, end in waiting:
        end.synchronize()
        total = _totals.setdefault(name, [0.0, 0])
        total[0] += start.elapsed_time(end)
        total[1] += 1
    return {name: (ms, calls) for name, (ms, calls) in _totals.items()}
