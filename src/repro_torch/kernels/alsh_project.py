"""CUDA wrapper of the §4.2.3 ALSH projection kernel (``csrc/alsh_project.cu``).

Counterpart of ``repro.kernels.alsh_project`` (the Pallas one-hot MXU
kernel). The CUDA source carries the design note; the plain version is
``repro_torch.kernels.ref.alsh_project``.

The kernel reads the folded tables in a relayout, :func:`tile_folded`:
(ceil(H/64), d, M+1, 64), hashes in groups of 64 with the hash innermost,
hashes past H zero. ``PrefixTables`` builds it once beside ``folded`` on
the card; :func:`untile_folded` takes it back.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import ALSH_PROJECT as KERNEL
from repro_torch.kernels._build import require, stream_of

HASH_GROUP = 64  # hashes per block of the kernel, two per lane
SMEM_LIMIT = 227 * 1024


def min_smem_bytes(m1: int) -> int:
    """The least shared memory a block of the kernel takes for M+1 = ``m1``
    levels: two staged chunks of one coordinate of a hash group, with the
    offsets and weights of 256 rows."""
    return 2 * (4 * HASH_GROUP * m1 + 2 * 4 * 256)


def tile_folded(folded: torch.Tensor) -> torch.Tensor:
    """(H, d, M+1) -> (ceil(H/64), d, M+1, 64): hash h at [h // 64, :, :, h % 64]."""
    H, d, m1 = folded.shape
    groups = -(-H // HASH_GROUP)
    padded = folded.new_zeros((groups * HASH_GROUP, d, m1))
    padded[:H] = folded
    return padded.reshape(groups, HASH_GROUP, d, m1).permute(0, 2, 3, 1).contiguous()


def untile_folded(tiled: torch.Tensor, H: int) -> torch.Tensor:
    """The inverse of :func:`tile_folded`: (G, d, M+1, 64) -> (H, d, M+1)."""
    groups, d, m1, hb = tiled.shape
    return tiled.permute(0, 3, 1, 2).reshape(groups * hb, d, m1)[:H].contiguous()


def alsh_project_cuda(
    levels: torch.Tensor,
    folded: torch.Tensor,
    weights: torch.Tensor | None = None,
    tiled: torch.Tensor | None = None,
) -> torch.Tensor:
    """levels (n, d) int32, folded (H, d, M+1) f32, weights (n, d) f32 or None
    -> (n, H) f32, all on one CUDA device. Levels outside {0..M} are clamped.
    ``tiled`` is ``tile_folded(folded)``, made here when not given."""
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
    if min_smem_bytes(m1) > SMEM_LIMIT:
        raise ValueError(f"alsh_project_cuda: M+1={m1} levels exceed one block's shared memory")
    if tiled is None:
        tiled = tile_folded(folded)
    require(tiled, "tiled", torch.float32, 4, dev)
    if tuple(tiled.shape) != (-(-H // HASH_GROUP), d, m1, HASH_GROUP):
        raise ValueError(f"tiled must be tile_folded(folded), got shape {tuple(tiled.shape)}")
    if tiled.data_ptr() % 16:
        raise ValueError("tiled must be 16-byte aligned")
    out = torch.empty((n, H), dtype=torch.float32, device=dev)
    if n == 0 or H == 0:
        return out
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        KERNEL.launches += 1
        err = lib.alsh_project_launch(
            levels.data_ptr(),
            None if weights is None else weights.data_ptr(),
            tiled.data_ptr(),
            out.data_ptr(),
            n, d, H, m1,
            stream_of(levels),
        )
    KERNEL.check(err, "alsh_project launch")
    return out
