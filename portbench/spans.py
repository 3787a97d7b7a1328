"""The program's own spans in the traced window: the ``repro_torch.*`` host
spans that ``repro_torch.obs`` records while a profiler runs, and the stage
times it resolves from its timing events.

Each idle gap of the device (the complement of ``Trace.busy`` in the
window, as ``Trace.idle_gaps`` takes it) is placed by its midpoint in the
program's spans open there, looked up over every span however far back it
began: in a stage span it is the engine's, else in ``repro_torch.query`` or
``repro_torch.validate`` the facade's, else the client's. The three parts
add up to the window's idle time.
"""

from __future__ import annotations

import bisect

PREFIX = "repro_torch."
QUERY = PREFIX + "query"
FACADE = {QUERY, PREFIX + "validate"}
STAGES = ("keys", "probe", "dedupe", "gather", "scan")
ENGINE = {PREFIX + s for s in STAGES}
# CUDA runtime calls that block the host until the device is done
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy"}


def has_program_spans(trace) -> bool:
    """Whether a trace holds device work and the program's query spans
    (a program without ``repro_torch.obs`` records none)."""
    return (trace is not None and bool(trace.kernels)
            and any(name == QUERY for name, _, _ in trace.host))


def idle_gaps(trace) -> list[tuple[int, int]]:
    """The window's idle gaps ``(start, end)``: the complement of the busy
    device intervals."""
    gaps = []
    edge = trace.window[0]
    for s, e in trace.busy() + [(trace.window[1], trace.window[1])]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    return gaps


def idle_by_layer(trace) -> dict[str, int]:
    """Idle nanoseconds of the window by the layer whose span was open at
    each gap's midpoint: ``engine``, ``facade`` or ``client``."""
    spans = sorted((s for s in trace.host if s[0].startswith(PREFIX)),
                   key=lambda s: (s[1], -s[2]))
    out = {"engine": 0, "facade": 0, "client": 0}
    open_spans: list = []  # nested spans of one host thread, innermost last
    i = 0
    for start, end in idle_gaps(trace):
        mid = (start + end) // 2
        while i < len(spans) and spans[i][1] <= mid:
            while open_spans and open_spans[-1][2] < spans[i][1]:
                open_spans.pop()
            open_spans.append(spans[i])
            i += 1
        while open_spans and open_spans[-1][2] < mid:
            open_spans.pop()
        names = {s[0] for s in open_spans}
        layer = "engine" if names & ENGINE else "facade" if names & FACADE else "client"
        out[layer] += end - start
    return out


def idle_ms(ctx, layer: str) -> float | None:
    """Idle device ms a batch in one layer's spans."""
    if not has_program_spans(ctx.trace):
        return None
    return idle_by_layer(ctx.trace)[layer] / 1e6 / len(ctx.batches)


def syncs_per_batch(ctx) -> float | None:
    """Blocking CUDA runtime calls a batch that start inside a
    ``repro_torch.query`` span."""
    if not has_program_spans(ctx.trace):
        return None
    queries = sorted((s, e) for name, s, e in ctx.trace.host if name == QUERY)
    starts = [s for s, _ in queries]
    count = 0
    for name, s, _ in ctx.trace.host:
        if name in SYNCS:
            j = bisect.bisect_right(starts, s) - 1
            count += j >= 0 and s <= queries[j][1]
    return count / len(ctx.batches)


def stage_ms(ctx, stage: str) -> float | None:
    """Milliseconds a batch of one timed stage, as ``repro_torch.obs``
    resolves them after the window: from the stream reaching the stage to
    its last operation done."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    try:
        from repro_torch import obs
    except ImportError:  # a program without stage spans
        return None
    total = obs.stage_ms().get(stage)
    return None if total is None else total[0] / len(ctx.batches)
