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
from repro_torch.kernels._build import on_device, raw_stream, require

GRID_Y_MAX = 65535  # CUDA's limit on gridDim.y
# The scan's schedule, as in csrc/wl1_distance.cu: a block owns BLOCK_QUERIES
# queries and a run of whole TILE_ROWS-row tiles
BLOCK_QUERIES = 64
TILE_ROWS = 256
# The most rows the scan takes: its row arithmetic (a split's end, a tile's
# last row) stays within a C int
MAX_ROWS = 2**31 - 1 - GRID_Y_MAX * TILE_ROWS


def scan_row_splits(n: int) -> int:
    """The row splits ``S`` of the materializing scan's grid (query tiles x
    ``S``) for ``n`` rows: one ``TILE_ROWS``-row tile per block, as many
    blocks as tiles up to CUDA's ``GRID_Y_MAX``; past that, whole tiles
    shared out evenly (``ceil(tiles / S)`` each, ``S`` trimmed so that none
    is empty). A block's ring walks on from one of its tiles into the next.
    Raises ValueError past ``MAX_ROWS``."""
    if n > MAX_ROWS:
        raise ValueError(f"wl1_scan takes at most {MAX_ROWS} rows, got {n}")
    tiles = -(-n // TILE_ROWS)
    if tiles == 0:
        return 1
    per = -(-tiles // min(tiles, GRID_Y_MAX))
    return -(-tiles // per)


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
    S = scan_row_splits(n)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    lib = SCAN_KERNEL.lib()
    with on_device(dev):
        SCAN_KERNEL.launches += 1
        err = lib.wl1_scan_launch(
            data.data_ptr(), queries.data_ptr(), weights.data_ptr(), out.data_ptr(),
            n, d, b, S,
            raw_stream(dev),
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
    with on_device(dev):
        RERANK_KERNEL.launches += 1
        err = lib.wl1_rerank_launch(
            pts.data_ptr(), queries.data_ptr(), weights.data_ptr(), out.data_ptr(),
            b, C, d,
            raw_stream(dev),
        )
    RERANK_KERNEL.check(err, "wl1_rerank launch")
    return out
