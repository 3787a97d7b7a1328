"""CUDA wrapper of the exact streaming k-NN scan (``csrc/wl1_topk.cu``).

Counterpart of ``repro.kernels.wl1_topk.wl1_scan_topk_pallas``: the k
smallest d_w^l1 distances per query over every row, never writing the
(b, n) distance matrix. Two launches — per-split partial top-k lists, then
their merge — both hand-written. The plain version is
``repro_torch.kernels.ref.wl1_scan_topk``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import WL1_SCAN_TOPK as KERNEL
from repro_torch.kernels._build import require, stream_of

SMEM_LIMIT = 227 * 1024
# floats of the partial kernel's staged tiles: q/w (32 x 68 each) + rows (256 x 33)
_TILE_FLOATS = 2 * 32 * 68 + 256 * 33
_BQ = 64  # queries per block


def wl1_scan_topk_cuda(
    data: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """data (n, d), queries/weights (b, d), all f32 on one CUDA device ->
    ((b, k) ascending dists, (b, k) int32 ids); (+inf, -1) where fewer than k
    rows exist; ties go to the lower id."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"wl1_scan_topk_cuda needs CUDA tensors, got {dev}")
    require(data, "data", torch.float32, 2, dev)
    require(queries, "queries", torch.float32, 2, dev)
    require(weights, "weights", torch.float32, 2, dev)
    n, d = data.shape
    b = queries.shape[0]
    if tuple(queries.shape) != (b, d) or tuple(weights.shape) != (b, d):
        raise ValueError(
            f"queries/weights must be {(b, d)}, got {tuple(queries.shape)}/{tuple(weights.shape)}"
        )
    if not isinstance(k, int) or k <= 0:
        raise ValueError(f"k must be a positive int, got {k!r}")
    if 4 * (_TILE_FLOATS + 2 * _BQ * k) > SMEM_LIMIT:
        raise ValueError(f"wl1_scan_topk_cuda: k={k} exceeds one block's shared memory")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(float("inf")), out_i.fill_(-1)
    lib = KERNEL.lib()
    S = lib.wl1_scan_splits(n, b)
    part_d = torch.empty((b, S, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, S, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        KERNEL.launches += 1
        err = lib.wl1_scan_topk_launch(
            data.data_ptr(), queries.data_ptr(), weights.data_ptr(),
            part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            n, d, b, k, S,
            stream_of(data),
        )
    KERNEL.check(err, "wl1_scan_topk launches")
    return out_d, out_i
