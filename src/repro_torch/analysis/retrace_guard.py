"""The rebuild guard — counterpart of ``repro.analysis.retrace_guard``.

The reference watches a jit cache: a steady-state retrace means a shape or
static argument leaked past the warmup and a request paid compile latency.
The port has no jit cache. What a request can pay for here is a kernel
library built with ``nvcc`` or loaded with ``ctypes`` on its path, so the
guard watches the count of those (``kernels._build.library_loads``).

Usage::

    guard = RetraceGuard()          # watches the kernel-library count
    guard.snapshot()                # after warmup
    ...serve...
    guard.assert_no_retrace()       # raises RetraceError naming the growth

    with RetraceGuard(fn=my_counter) as g:   # scoped form over any count
        ...

``RetraceError`` subclasses ``AssertionError``, as in the reference.
"""

from __future__ import annotations

from typing import Callable, Optional

from repro_torch.kernels._build import library_loads


class RetraceError(AssertionError):
    """A watched count grew after its snapshot — something was built or
    loaded while it should only have run."""


class RetraceGuard:
    """Snapshot a count and assert it never grows afterwards.

    Args:
      fn: a callable returning the count to watch. ``None`` (default)
        watches :func:`library_loads`, the kernel libraries built or loaded
        in this process.
    """

    def __init__(self, fn: Optional[Callable[[], int]] = None):
        self._size: Callable[[], int] = library_loads if fn is None else fn
        self._snapshot: Optional[int] = None

    def cache_size(self) -> int:
        """Current value of the watched count."""
        return self._size()

    @property
    def snapshotted(self) -> bool:
        return self._snapshot is not None

    @property
    def baseline(self) -> Optional[int]:
        """The snapshotted count (None before :meth:`snapshot`)."""
        return self._snapshot

    def snapshot(self) -> int:
        """Record the current count as the no-rebuild baseline."""
        self._snapshot = self._size()
        return self._snapshot

    def assert_no_retrace(self, context: str = "") -> None:
        """Raise :class:`RetraceError` if the count grew since snapshot."""
        if self._snapshot is None:
            raise RuntimeError(
                "RetraceGuard.assert_no_retrace needs snapshot() first"
            )
        now = self._size()
        if now > self._snapshot:
            where = f" during {context}" if context else ""
            raise RetraceError(
                f"kernel libraries built or loaded grew {self._snapshot} -> "
                f"{now}{where}: a kernel not covered by the snapshot was "
                f"built or loaded on the serving path"
            )

    def __enter__(self) -> "RetraceGuard":
        self.snapshot()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.assert_no_retrace()
