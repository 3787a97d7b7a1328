"""CUDA wrappers of the fused probe tail: gather candidate rows by id,
exact d_w^l1 re-rank, top-k.

  * ``gather_rerank_topk_cuda`` (``csrc/gather_rerank.cu``): f32 rows —
    counterpart of ``repro.kernels.gather_rerank.gather_rerank_topk_pallas``.
    Many warps per query: each query's slots are cut into ``S`` splits
    (:func:`gather_splits`), one block of ``SPLIT_WARPS`` warps per (query,
    split), and with ``S > 1`` a second launch merges the splits' lists;
  * ``gather_rerank_topk_blocked_cuda`` (``csrc/gather_rerank_blocked.cu``):
    rows in their stored dtype (bf16, int8, or f32 with scales), decoded in
    registers, one warp per query — counterpart of
    ``gather_rerank_topk_pallas_blocked``. Its f32 case without scales runs
    the one-warp schedule over f32 rows, bit for bit what the f32 kernel
    returns.

With ``delta=`` (a mutable index's delta segment) each launches its
two-segment entry, whose ids address the virtual ``[data; delta]`` table;
the two-segment entries count their launches apart, one per call whether
the call made one launch or two. The plain versions are
``repro_torch.kernels.ref.gather_rerank_topk`` and, with a delta,
``gather_rerank_topk_segmented``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import GATHER_RERANK as KERNEL
from repro_torch.kernels._build import GATHER_RERANK_BLOCKED as BLOCKED_KERNEL
from repro_torch.kernels._build import GATHER_RERANK_BLOCKED_TWO_SEG as BLOCKED_TWO_SEG_KERNEL
from repro_torch.kernels._build import GATHER_RERANK_TWO_SEG as TWO_SEG_KERNEL
from repro_torch.kernels._build import require, stream_of

SMEM_LIMIT = 227 * 1024
WARPS = 4  # queries per block of the one-warp-per-query schedule (the quantized kernels)
# The f32 kernels' schedule, as in csrc/gather_rerank.cu
SPLIT_WARPS = 8  # warps per block: one query, one slot range
SPLIT_MIN_BLOCKS = 3  # blocks per SM its registers allow (__launch_bounds__)
MIN_GROUPS_PER_WARP = 4  # fewest 32-slot groups a warp of a split walks
STORED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # codes of the C launch


def gather_splits(b: int, P: int, sm_count: int) -> int:
    """The number of slot splits ``S`` of the f32 kernels for ``b`` queries
    of ``P`` slots on a card of ``sm_count`` SMs.

    A block owns one (query, split). ``b`` blocks fill the card when they
    reach ``SPLIT_MIN_BLOCKS`` per SM; below that each query's slots are cut
    into up to ``SPLIT_MIN_BLOCKS * sm_count // b`` contiguous ranges, so
    one wave of (b, S) blocks fills the card, but never so many that a warp
    of a split walks fewer than ``MIN_GROUPS_PER_WARP`` 32-slot groups. The
    ranges are whole groups, ``ceil(groups / S)`` each, and ``S`` is then
    trimmed so that none is empty."""
    groups = -(-P // 32)
    if groups == 0 or b <= 0:
        return 1
    fill = SPLIT_MIN_BLOCKS * sm_count // b
    most = groups // (SPLIT_WARPS * MIN_GROUPS_PER_WARP)
    S = max(1, min(fill, most))
    per = -(-groups // S)
    return -(-groups // per)


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_args(data, ids, queries, weights, k, smem: int) -> None:
    """Device, dtype, shape and shared-memory checks common to both kernels;
    ``smem`` is the bytes of shared memory one block of the kernel takes."""
    dev = data.device
    require(ids, "ids", torch.int32, 2, dev)
    require(queries, "queries", torch.float32, 2, dev)
    require(weights, "weights", torch.float32, 2, dev)
    d = data.shape[1]
    b = ids.shape[0]
    if tuple(queries.shape) != (b, d) or tuple(weights.shape) != (b, d):
        raise ValueError(
            f"queries/weights must be {(b, d)}, got {tuple(queries.shape)}/{tuple(weights.shape)}"
        )
    if not isinstance(k, int) or k <= 0:
        raise ValueError(f"k must be a positive int, got {k!r}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"gather_rerank: d={d}, k={k} exceed one block's shared memory")


def _dpad(d: int) -> int:
    return -(-d // 4) * 4


def _delta_arg(data: torch.Tensor, delta: torch.Tensor | None) -> torch.Tensor | None:
    """The delta table cast through the main table's dtype (no copy when it
    already has it), checked like the main table; ids must fit int32."""
    if delta is None:
        return None
    if not isinstance(delta, torch.Tensor):
        raise TypeError(f"delta must be a torch.Tensor, got {type(delta).__name__}")
    delta = delta.to(data.dtype)
    require(delta, "delta", data.dtype, 2, data.device)
    if delta.shape[1] != data.shape[1]:
        raise ValueError(f"delta must be (cap, {data.shape[1]}), got {tuple(delta.shape)}")
    if data.shape[0] + delta.shape[0] >= 2**31:
        raise ValueError("n_main + cap must fit int32 ids")
    return delta


def gather_rerank_topk_cuda(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """data (n, d) f32, ids (b, P) int32 (>= n or < 0 ⇒ invalid),
    queries/weights (b, d) f32 -> ((b, k) ascending dists, (b, k) int32 ids),
    (+inf, -1) where invalid; ties go to the earlier candidate slot. With
    ``delta`` (cap, d) the ids address ``[data; delta]`` (>= n + cap ⇒
    invalid) and the two-segment entry launches. The slots are cut into
    :func:`gather_splits` splits; with more than one, a (b, S, k) scratch
    holds the splits' lists for the merge launch."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rerank_topk_cuda needs CUDA tensors, got {dev}")
    require(data, "data", torch.float32, 2, dev)
    delta = _delta_arg(data, delta)
    n, d = data.shape
    _check_args(data, ids, queries, weights, k,
                smem=4 * (2 * _dpad(d) + 2 * SPLIT_WARPS * k + SPLIT_WARPS))
    b, P = ids.shape
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    S = gather_splits(b, P, _sm_count(dev))
    part_ptrs = (None, None)
    if S > 1:  # the splits' (dist, slot) lists
        part_d = torch.empty((b, S, k), dtype=torch.float32, device=dev)
        part_s = torch.empty((b, S, k), dtype=torch.int32, device=dev)
        part_ptrs = (part_d.data_ptr(), part_s.data_ptr())
    kernel = KERNEL if delta is None else TWO_SEG_KERNEL
    lib = kernel.lib()
    with torch.cuda.device(dev):
        kernel.launches += 1
        if delta is None:
            err = lib.gather_rerank_launch(
                data.data_ptr(), ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *part_ptrs,
                n, d, b, P, k, S,
                stream_of(data),
            )
        else:
            err = lib.gather_rerank2_launch(
                data.data_ptr(), delta.data_ptr(), ids.data_ptr(), queries.data_ptr(),
                weights.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), *part_ptrs,
                n, delta.shape[0], d, b, P, k, S,
                stream_of(data),
            )
    kernel.check(err, f"{kernel.name} launch")
    return out_d, out_i


def gather_rerank_topk_blocked_cuda(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """data (n, d) in its stored dtype (bf16, int8 or f32), scales (d,) f32
    or None, ids (b, P) int32 (>= n or < 0 ⇒ invalid), queries/weights
    (b, d) f32 -> ((b, k) ascending dists, (b, k) int32 ids), (+inf, -1)
    where invalid. Each gathered row is decoded as ``row.float() * scales``
    (the plain widening without scales); ties go to the earlier slot. With
    ``delta`` (cap, d), cast to ``data``'s dtype, the ids address
    ``[data; delta]`` (>= n + cap ⇒ invalid), one ``scales`` decodes both,
    and the two-segment entry launches."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"gather_rerank_topk_blocked_cuda needs CUDA tensors, got {dev}")
    if data.dtype not in STORED_DTYPES:
        raise TypeError(f"data must be one of {list(STORED_DTYPES)}, got {data.dtype}")
    require(data, "data", data.dtype, 2, dev)
    delta = _delta_arg(data, delta)
    n, d = data.shape
    if scales is not None:
        require(scales, "scales", torch.float32, 1, dev)
        if scales.shape[0] != d:
            raise ValueError(f"scales must be ({d},), got {tuple(scales.shape)}")
    _check_args(data, ids, queries, weights, k,
                smem=4 * WARPS * ((2 if scales is None else 3) * _dpad(d) + 2 * k))
    b, P = ids.shape
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    kernel = BLOCKED_KERNEL if delta is None else BLOCKED_TWO_SEG_KERNEL
    lib = kernel.lib()
    scales_ptr = None if scales is None else scales.data_ptr()
    with torch.cuda.device(dev):
        kernel.launches += 1
        if delta is None:
            err = lib.gather_rerank_blocked_launch(
                data.data_ptr(), STORED_DTYPES[data.dtype], scales_ptr,
                ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(),
                n, d, b, P, k,
                stream_of(data),
            )
        else:
            err = lib.gather_rerank_blocked2_launch(
                data.data_ptr(), delta.data_ptr(), STORED_DTYPES[data.dtype], scales_ptr,
                ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(),
                n, delta.shape[0], d, b, P, k,
                stream_of(data),
            )
    kernel.check(err, f"{kernel.name} launch")
    return out_d, out_i
