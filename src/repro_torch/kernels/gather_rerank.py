"""CUDA wrapper of the fused probe tail (``csrc/gather_rerank.cu``):
gather candidate rows by id, exact d_w^l1 re-rank, top-k.

Counterpart of ``repro.kernels.gather_rerank.gather_rerank_topk_pallas``
(single segment, f32 rows). The two-segment and quantized schedules are not
ported yet (ROADMAP.md Queue B). The plain version is
``repro_torch.kernels.ref.gather_rerank_topk``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import GATHER_RERANK as KERNEL
from repro_torch.kernels._build import require, stream_of

SMEM_LIMIT = 227 * 1024
WARPS = 4  # queries per block, as in the CUDA source


def gather_rerank_topk_cuda(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """data (n, d) f32, ids (b, P) int32 (>= n or < 0 ⇒ invalid),
    queries/weights (b, d) f32 -> ((b, k) ascending dists, (b, k) int32 ids),
    (+inf, -1) where invalid; ties go to the earlier candidate slot."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rerank_topk_cuda needs CUDA tensors, got {dev}")
    require(data, "data", torch.float32, 2, dev)
    require(ids, "ids", torch.int32, 2, dev)
    require(queries, "queries", torch.float32, 2, dev)
    require(weights, "weights", torch.float32, 2, dev)
    n, d = data.shape
    b, P = ids.shape
    if tuple(queries.shape) != (b, d) or tuple(weights.shape) != (b, d):
        raise ValueError(
            f"queries/weights must be {(b, d)}, got {tuple(queries.shape)}/{tuple(weights.shape)}"
        )
    if not isinstance(k, int) or k <= 0:
        raise ValueError(f"k must be a positive int, got {k!r}")
    dpad = -(-d // 4) * 4
    if 4 * WARPS * (2 * dpad + 2 * k) > SMEM_LIMIT:
        raise ValueError(f"gather_rerank_topk_cuda: d={d}, k={k} exceed one block's shared memory")
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = KERNEL.lib()
    with torch.cuda.device(dev):
        KERNEL.launches += 1
        err = lib.gather_rerank_launch(
            data.data_ptr(), ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            n, d, b, P, k,
            stream_of(data),
        )
    KERNEL.check(err, "gather_rerank launch")
    return out_d, out_i
