"""CUDA wrapper of the candidate dedupe (``csrc/dedupe_candidates.cu``).

Replaces no Pallas kernel: the reference dedupes in jnp
(``repro.core.index._dedupe_candidates``, two sorts). The kernel packs each
row's distinct valid ids ascending, then the sentinel, in one launch that
reads the (b, P) block once and writes the packed block and the counts
once, through a bitmap of the id range in shared memory; the CUDA source
carries the design note. The plain version is
``repro_torch.kernels.ref.dedupe_candidates``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import DEDUPE_CANDIDATES as KERNEL
from repro_torch.kernels._build import on_device, raw_stream, require

MAX_SLOTS = 1 << 30  # the widest row the kernel indexes


def tile_plan(n: int) -> tuple[int, int, int]:
    """The launch's plan for the id range [0, n), as the CUDA source makes
    it: (tiles, summary words a tile, bytes of dynamic shared memory a
    block). Builds the kernel library if it is not built."""
    plan = (ctypes.c_int * 3)()
    KERNEL.check(KERNEL.lib().dedupe_candidates_plan(n, ctypes.addressof(plan)),
                 "dedupe_candidates plan")
    return plan[0], plan[1], plan[2]


def dedupe_candidates_cuda(cand: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """cand (b, P) int32 ids on a CUDA device (an id outside [0, n) is
    padding) -> ((b, P) int32: each row's distinct ids below n ascending,
    then ``n``; (b,) int32 counts of those ids). No path emits a negative
    id; the kernel drops one as padding."""
    require(cand, "cand", torch.int32, 2, cand.device)
    if not 0 <= n < 2**31:
        raise ValueError(f"dedupe_candidates_cuda: n={n} must be in [0, 2**31)")
    dev = cand.device
    if dev.type != "cuda":
        raise ValueError(f"dedupe_candidates_cuda needs a CUDA tensor, got {dev}")
    b, P = cand.shape
    if P > MAX_SLOTS:
        raise ValueError(f"dedupe_candidates_cuda: P={P} slots exceed {MAX_SLOTS}")
    out = torch.empty((b, P), dtype=torch.int32, device=dev)
    counts = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return out, counts
    vec = int(P % 4 == 0 and cand.data_ptr() % 16 == 0)
    lib = KERNEL.lib()
    with on_device(dev):
        KERNEL.launches += 1
        err = lib.dedupe_candidates_launch(
            cand.data_ptr(), out.data_ptr(), counts.data_ptr(), b, P, n, vec, raw_stream(dev),
        )
    KERNEL.check(err, "dedupe_candidates launch")
    return out, counts
