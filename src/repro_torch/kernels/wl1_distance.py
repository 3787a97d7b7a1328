"""CUDA wrappers of the materializing weighted-L1 kernels (``csrc/wl1_distance.cu``).

  * ``wl1_scan_cuda``: the brute-force scan, (n, d) rows x (b, d) queries
    -> the (b, n) distance matrix — counterpart of
    ``repro.kernels.wl1_distance.wl1_scan_pallas``;
  * ``wl1_rerank_cuda``: the candidate re-rank, (b, C, d) points -> (b, C)
    — counterpart of ``wl1_rerank_pallas``.

Both write every distance (no top-k): they are the unfused baseline the
fused kernels are measured against. The two share one source and count
their launches apart. The plain versions are
``repro_torch.kernels.ref.wl1_scan`` and ``wl1_rerank``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import WL1_RERANK as RERANK_KERNEL
from repro_torch.kernels._build import WL1_SCAN as SCAN_KERNEL
from repro_torch.kernels._build import require, stream_of

GRID_Y_MAX = 65535  # CUDA's limit on gridDim.y
SCAN_ROWS_PER_BLOCK = 256  # as in the CUDA source


def _query_args(queries: torch.Tensor, weights: torch.Tensor, b: int | None, d: int, dev) -> int:
    """Check queries/weights as (b, d) f32 (b from ``queries`` when None); returns b."""
    require(queries, "queries", torch.float32, 2, dev)
    require(weights, "weights", torch.float32, 2, dev)
    b = queries.shape[0] if b is None else b
    if tuple(queries.shape) != (b, d) or tuple(weights.shape) != (b, d):
        raise ValueError(
            f"queries/weights must be {(b, d)}, got {tuple(queries.shape)}/{tuple(weights.shape)}"
        )
    return b


def wl1_scan_cuda(data: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """data (n, d), queries/weights (b, d), all f32 on one CUDA device ->
    (b, n) f32 distances ``sum_i w_i |x_i - q_i|``."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"wl1_scan_cuda needs CUDA tensors, got {dev}")
    require(data, "data", torch.float32, 2, dev)
    n, d = data.shape
    b = _query_args(queries, weights, None, d, dev)
    if -(-n // SCAN_ROWS_PER_BLOCK) > GRID_Y_MAX:
        raise ValueError(f"wl1_scan_cuda: n={n} exceeds {GRID_Y_MAX * SCAN_ROWS_PER_BLOCK} rows")
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    lib = SCAN_KERNEL.lib()
    with torch.cuda.device(dev):
        SCAN_KERNEL.launches += 1
        err = lib.wl1_scan_launch(
            data.data_ptr(), queries.data_ptr(), weights.data_ptr(), out.data_ptr(),
            n, d, b,
            stream_of(data),
        )
    SCAN_KERNEL.check(err, "wl1_scan launch")
    return out


def wl1_rerank_cuda(pts: torch.Tensor, queries: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """pts (b, C, d), queries/weights (b, d), all f32 on one CUDA device ->
    (b, C) f32 distances ``sum_i w_i |p_i - q_i|``."""
    dev = pts.device
    if dev.type != "cuda":
        raise ValueError(f"wl1_rerank_cuda needs CUDA tensors, got {dev}")
    require(pts, "pts", torch.float32, 3, dev)
    b, C, d = pts.shape
    _query_args(queries, weights, b, d, dev)
    if b > GRID_Y_MAX:
        raise ValueError(f"wl1_rerank_cuda: b={b} exceeds {GRID_Y_MAX} queries")
    out = torch.empty((b, C), dtype=torch.float32, device=dev)
    if b == 0 or C == 0:
        return out
    lib = RERANK_KERNEL.lib()
    with torch.cuda.device(dev):
        RERANK_KERNEL.launches += 1
        err = lib.wl1_rerank_launch(
            pts.data_ptr(), queries.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, C, d,
            stream_of(pts),
        )
    RERANK_KERNEL.check(err, "wl1_rerank launch")
    return out
