"""What a ``torch.profiler`` trace of the measured window holds, reduced to
intervals: device operations (kernels, copies, sets), host events, and the
window's own span.

Times are nanoseconds on the profiler's clock. The window is the span of
the ``portbench.window`` annotation; device work outside it is dropped.
"""

from __future__ import annotations

import bisect
import re

WINDOW_SPAN = "portbench.window"
KERNEL = "kernel"
COPIES = ("gpu_memcpy", "gpu_memset")
HOST_SCAN = 256  # host events looked back over to place one idle gap


def _kind(event) -> str | None:
    """A device event's activity type ("kernel", "gpu_memcpy", ...), where
    the profiler tells it."""
    kind = getattr(event, "activity_type", None)
    return kind() if callable(kind) else None


def short_name(name: str) -> str:
    """A device operation's name without its return type and parameters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()


class Trace:
    """Device intervals ``(name, start, end)`` split into kernels and copies,
    host intervals, and the window ``(start, end)``."""

    def __init__(self, kernels: list, copies: list, host: list, window: tuple[int, int]):
        self.window = window
        lo, hi = window
        self.kernels = [e for e in kernels if lo <= e[1] < hi]
        self.copies = [e for e in copies if lo <= e[1] < hi]
        self.host = sorted(host, key=lambda e: e[1])

    @classmethod
    def from_profiler(cls, prof) -> "Trace | None":
        """The window's intervals, or None when the trace holds no window."""
        from torch.autograd import DeviceType

        kernels, copies, host, window = [], [], [], None
        device = []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns()
            item = (e.name(), start, start + e.duration_ns())
            if e.device_type() == DeviceType.CPU:
                if item[0] == WINDOW_SPAN:
                    window = item[1:]
                else:
                    host.append(item)
            else:
                device.append((_kind(e), item))
        host_names = {name for name, _, _ in host} | {WINDOW_SPAN}
        for kind, item in device:
            if kind is None:  # a profiler without activity types: tell by name
                if item[0] in host_names:
                    continue  # a host span's shadow on the device timeline
                kind = COPIES[0] if item[0].startswith(("Memcpy", "Memset")) else KERNEL
            if kind == KERNEL:
                kernels.append(item)
            elif kind in COPIES:
                copies.append(item)
        return None if window is None else cls(kernels, copies, host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device intervals, clipped to the window."""
        spans = sorted((s, min(e, self.window[1])) for _, s, e in self.kernels + self.copies)
        merged: list[list[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def kernel_seconds(self, symbols) -> float:
        """Device seconds of the kernels whose names hold one of ``symbols``
        as a whole identifier."""
        pat = re.compile(r"\b(?:%s)\b" % "|".join(map(re.escape, symbols)))
        return sum(e - s for name, s, e in self.kernels if pat.search(name)) / 1e9

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time: [[name, seconds], ...]."""
        by_name: dict[str, int] = {}
        for name, s, e in self.kernels + self.copies:
            key = short_name(name)
            by_name[key] = by_name.get(key, 0) + (e - s)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time by the host event running at each gap's middle
        (the innermost one), summed: [[name, seconds], ...]."""
        starts = [e[1] for e in self.host]
        by_name: dict[str, int] = {}
        edge = self.window[0]
        for s, e in self.busy() + [(self.window[1], self.window[1])]:
            if s > edge:
                mid = (edge + s) // 2
                name = "host outside any op"
                i = bisect.bisect_right(starts, mid) - 1
                for j in range(i, max(i - HOST_SCAN, -1), -1):
                    if self.host[j][2] >= mid:
                        name = self.host[j][0]
                        break
                by_name[name] = by_name.get(name, 0) + (s - edge)
            edge = max(edge, e)
        ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return [[name, ns / 1e9] for name, ns in ranked]
