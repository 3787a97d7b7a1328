"""CUDA wrapper of the §4.2.3 ALSH projection kernel (``csrc/alsh_project.cu``).

Counterpart of ``repro.kernels.alsh_project`` (the Pallas one-hot MXU
kernel). The CUDA source carries the design note; the plain version is
``repro_torch.kernels.ref.alsh_project``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import ALSH_PROJECT as KERNEL
from repro_torch.kernels._build import require, stream_of


def alsh_project_cuda(
    levels: torch.Tensor, folded: torch.Tensor, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """levels (n, d) int32, folded (H, d, M+1) f32, weights (n, d) f32 or None
    -> (n, H) f32, all on one CUDA device. Levels outside {0..M} are clamped."""
    dev = levels.device
    if dev.type != "cuda":
        raise ValueError(f"alsh_project_cuda needs CUDA tensors, got {dev}")
    require(levels, "levels", torch.int32, 2, dev)
    require(folded, "folded", torch.float32, 3, dev)
    n, d = levels.shape
    H, d2, m1 = folded.shape
    if d2 != d:
        raise ValueError(f"folded has d={d2} but levels have d={d}")
    if weights is not None:
        require(weights, "weights", torch.float32, 2, dev)
        if tuple(weights.shape) != (n, d):
            raise ValueError(f"weights must be {(n, d)}, got {tuple(weights.shape)}")
    out = torch.empty((n, H), dtype=torch.float32, device=dev)
    if n == 0 or H == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        KERNEL.launches += 1
        err = lib.alsh_project_launch(
            levels.data_ptr(),
            None if weights is None else weights.data_ptr(),
            folded.data_ptr(),
            out.data_ptr(),
            n, d, H, m1,
            stream_of(levels),
        )
    KERNEL.check(err, "alsh_project launch")
    return out
