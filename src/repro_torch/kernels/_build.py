"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first CUDA use with ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface and loaded with ``ctypes`` — no
PyTorch headers, so a build takes seconds. Libraries land in
``csrc/build/`` (listed in ``.gitignore``) under a name that hashes the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. :func:`build_all` starts one ``nvcc`` per source, all at once. A
source may export several entry points, each a :class:`Kernel` of its own
with its own launch count (the single- and two-segment gathers share their
sources, as do the materializing scan and re-rank, and each source builds
once).

Nothing here runs at import time: the CPU tests import every module of the
package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int


# Libraries built or loaded by ``Kernel.lib`` in this process: the count a
# server snapshots after warmup (``repro_torch.analysis.retrace_guard``),
# since a build or load while serving is paid by the request that hit it.
_LIBRARY_LOADS = 0


def library_loads() -> int:
    """How many kernel libraries ``Kernel.lib`` has built or loaded in this
    process (each kernel's first use counts once; later calls reuse it)."""
    return _LIBRARY_LOADS


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the PATH, or
    the toolkit's default location."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the repro_torch "
        "CUDA kernels are compiled from csrc/ at first use on the GPU"
    )


@dataclasses.dataclass
class Kernel:
    """One CUDA kernel: its source, its C entry points, and its launch count.

    ``functions`` maps each exported C function to its ctypes argtypes
    (every function returns ``int``). ``launches`` counts the wrapper's
    calls of its launch function — the wrapper adds one there and nowhere
    else (the scan's two launches, partial and merge, count once, as do the
    gathers' split and merge launches).
    """

    name: str
    source: str
    functions: dict
    launches: int = 0
    build_seconds: float | None = None
    build_log: str = ""
    _lib: ctypes.CDLL | None = dataclasses.field(default=None, repr=False)
    _tmp: Path | None = dataclasses.field(default=None, repr=False)  # build in flight
    _t0: float = dataclasses.field(default=0.0, repr=False)

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    @property
    def library_path(self) -> Path:
        h = hashlib.sha256()
        h.update(self.source_path.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> subprocess.Popen | None:
        """Start ``nvcc`` for this source (None when already built)."""
        if self.library_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source_path)]
        self._tmp = tmp
        self._t0 = time.perf_counter()
        return subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=CSRC
        )

    def finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        self.build_log = out
        self.build_seconds = time.perf_counter() - self._t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source_path}:\n{out}")
        os.replace(self._tmp, self.library_path)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed (counted by
        :func:`library_loads`)."""
        global _LIBRARY_LOADS
        if self._lib is None:
            _LIBRARY_LOADS += 1
            proc = self.start_build()
            if proc is not None:
                self.finish_build(proc)
            lib = ctypes.CDLL(str(self.library_path))
            for fn, argtypes in self.functions.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = _I
            lib.cuda_error_string.argtypes = [_I]
            lib.cuda_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch function returned a CUDA error."""
        if err != 0:
            msg = self.lib().cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {what} failed with CUDA error {err} ({msg})")


ALSH_PROJECT = Kernel(
    "alsh_project",
    "alsh_project.cu",
    {"alsh_project_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
)
GATHER_RERANK = Kernel(
    "gather_rerank_topk",
    "gather_rerank.cu",
    {"gather_rerank_launch": [_P] * 8 + [_I] * 6 + [_P],
     "gather_rerank_split_blocks": [_P, _P, _I]},
)
GATHER_RERANK_BLOCKED = Kernel(
    "gather_rerank_topk_blocked",
    "gather_rerank_blocked.cu",
    {"gather_rerank_blocked_launch": [_P, _I] + [_P] * 8 + [_I] * 6 + [_P],
     "gather_rerank_blocked_split_blocks": [_P, _P, _I, _I, _I]},
)
GATHER_RERANK_TWO_SEG = Kernel(
    "gather_rerank_topk_two_seg",
    "gather_rerank.cu",
    {"gather_rerank2_launch": [_P] * 9 + [_I] * 7 + [_P]},
)
GATHER_RERANK_BLOCKED_TWO_SEG = Kernel(
    "gather_rerank_topk_blocked_two_seg",
    "gather_rerank_blocked.cu",
    {"gather_rerank_blocked2_launch": [_P, _P, _I] + [_P] * 8 + [_I] * 7 + [_P]},
)
# The one-warp-per-query schedule of the stored-type source on its own: the
# bit reference of the split schedule for the tests and chip_smoke.py. No
# query path reaches it, so it is not in KERNELS (no launch count of a path,
# no row of the kernel table); its source builds with the others.
GATHER_RERANK_WARP = Kernel(
    "gather_rerank_topk_warp",
    "gather_rerank_blocked.cu",
    {"gather_rerank_warp_launch": [_P, _P, _I] + [_P] * 6 + [_I] * 6 + [_P]},
)
WL1_SCAN_TOPK = Kernel(
    "wl1_scan_topk",
    "wl1_topk.cu",
    {"wl1_scan_topk_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]},
)
WL1_SCAN = Kernel(
    "wl1_scan",
    "wl1_distance.cu",
    {"wl1_scan_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _P]},
)
WL1_RERANK = Kernel(
    "wl1_rerank",
    "wl1_distance.cu",
    {"wl1_rerank_launch": [_P, _P, _P, _P, _I, _I, _I, _P]},
)
KERNELS = {
    k.name: k
    for k in (ALSH_PROJECT, GATHER_RERANK, GATHER_RERANK_BLOCKED, WL1_SCAN_TOPK,
              GATHER_RERANK_TWO_SEG, GATHER_RERANK_BLOCKED_TWO_SEG, WL1_SCAN, WL1_RERANK)
}


def build_all() -> dict[str, Kernel]:
    """Compile every kernel source in parallel (one nvcc per source) and
    load every kernel; kernels that share a source share its build log."""
    by_source: dict[str, list[Kernel]] = {}
    for k in KERNELS.values():
        by_source.setdefault(k.source, []).append(k)
    procs = {src: ks[0].start_build() for src, ks in by_source.items()}
    for src, proc in procs.items():
        first, *rest = by_source[src]
        if proc is not None:
            first.finish_build(proc)
        for k in rest:
            k.build_seconds, k.build_log = first.build_seconds, first.build_log
    for k in KERNELS.values():
        k.lib()
    return KERNELS


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: k.launches for name, k in KERNELS.items()}


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add the launches another process counted (a spawned tuner worker's,
    read there with :func:`launch_counts`) to this process's counts."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def stream_of(t) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def raw_stream(device) -> int:
    """The current CUDA stream of ``device`` as a pointer-sized int, as
    :func:`stream_of` gives it, without building a ``torch.cuda.Stream``
    object (which costs more host time than a launch)."""
    import torch

    index = torch.cuda.current_device() if device.index is None else device.index
    return torch._C._cuda_getCurrentRawStream(index)


def on_device(device):
    """The device context of a launch on ``device``, entered only when it is
    not the current device (entering one costs more host time than a
    launch)."""
    import contextlib

    import torch

    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def require(t, name: str, dtype, ndim: int, device) -> None:
    """Validate a kernel argument before its pointer is handed to C."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if any(s >= 2**31 for s in t.shape):
        raise ValueError(f"{name}: every dim must fit int32, got shape {tuple(t.shape)}")
