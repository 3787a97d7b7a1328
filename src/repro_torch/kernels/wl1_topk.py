"""CUDA wrapper of the exact streaming k-NN scan (``csrc/wl1_topk.cu``).

Counterpart of ``repro.kernels.wl1_topk.wl1_scan_topk_pallas``: the k
smallest d_w^l1 distances per query over every row, never writing the
(b, n) distance matrix. The rows are cut into :func:`scan_splits` splits;
one launch keeps each split's k smallest (dist, id) per query and, with
more than one split, a second merges the splits' lists. Both are
hand-written. The plain version is ``repro_torch.kernels.ref.wl1_scan_topk``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import WL1_SCAN_TOPK as KERNEL
from repro_torch.kernels._build import require, stream_of

SMEM_LIMIT = 227 * 1024
# The partial kernel's schedule, as in csrc/wl1_topk.cu
BLOCK_QUERIES = 64  # queries per block
TILE_ROWS = 256  # rows per tile; a split is a run of whole tiles
BLOCKS_PER_SM = 2  # blocks per SM its registers and shared memory allow
MERGE_ENTRIES = 4096  # most split-list entries (S * k) one merge block stages
CANDIDATE_BUFFER = 32  # survivors a query holds before they are folded into its list
# bytes of the partial kernel's shared memory besides the per-k lists: a ring
# of 3 staged chunks (q/w 16 x 68 each + rows 256 x 17 floats), 64 candidate
# buffers of 32 (dist, id), 64 taus and fills
_FIXED_BYTES = 4 * (3 * (2 * 16 * 68 + 256 * 17) + 2 * 64 * 32 + 2 * 64)
_BYTES_PER_K = 8 * (64 + 8)  # (dist, id) lists of 64 queries + 8 warps' fold scratch


def scan_splits(n: int, b: int, k: int, sm_count: int) -> int:
    """The number of row splits ``S`` of the scan for ``n`` rows, ``b``
    queries and top-``k`` on a card of ``sm_count`` SMs.

    A block owns one query tile of ``BLOCK_QUERIES`` and one split. ``S`` is
    the most that keeps the grid within one wave of ``BLOCKS_PER_SM``
    blocks per SM, never more than the ``TILE_ROWS``-row tiles, and never so
    many that a query's split lists (``S * k`` entries) outgrow the merge
    block's ``MERGE_ENTRIES``. The splits are whole tiles, ``ceil(tiles /
    S)`` each, and ``S`` is then trimmed so that none is empty."""
    tiles = -(-n // TILE_ROWS)
    if tiles == 0 or b <= 0:
        return 1
    qtiles = -(-b // BLOCK_QUERIES)
    S = max(1, min(BLOCKS_PER_SM * sm_count // qtiles, tiles, MERGE_ENTRIES // k))
    per = -(-tiles // S)
    return -(-tiles // per)


def smem_bytes(k: int) -> int:
    """Shared memory of one partial block for top-``k``."""
    return _FIXED_BYTES + _BYTES_PER_K * k


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
    if smem_bytes(k) > SMEM_LIMIT:
        raise ValueError(f"wl1_scan_topk_cuda: k={k} exceeds one block's shared memory")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(float("inf")), out_i.fill_(-1)
    S = scan_splits(n, b, k, torch.cuda.get_device_properties(dev).multi_processor_count)
    part_d = part_i = None
    if S > 1:
        part_d = torch.empty((b, S, k), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, S, k), dtype=torch.int32, device=dev)
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        KERNEL.launches += 1
        err = lib.wl1_scan_topk_launch(
            data.data_ptr(), queries.data_ptr(), weights.data_ptr(),
            None if part_d is None else part_d.data_ptr(),
            None if part_i is None else part_i.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            n, d, b, k, S,
            stream_of(data),
        )
    KERNEL.check(err, "wl1_scan_topk launches")
    return out_d, out_i
