"""CUDA wrappers of the fused probe tail: gather candidate rows by id,
exact d_w^l1 re-rank, top-k.

Both kernels share one body and two schedules (``csrc/gather_rerank.cuh``):
the split schedule — each query's slots cut into ``S`` splits
(:func:`gather_splits`), one block of ``SPLIT_WARPS`` warps per (query,
split), and with ``S > 1`` a second launch that merges the splits' lists —
and one warp per query, ``WARPS`` queries per block.

  * ``gather_rerank_topk_cuda`` (``csrc/gather_rerank.cu``): f32 rows,
    always the split schedule — counterpart of
    ``repro.kernels.gather_rerank.gather_rerank_topk_pallas``;
  * ``gather_rerank_topk_blocked_cuda`` (``csrc/gather_rerank_blocked.cu``):
    rows in their stored dtype (bf16, int8, or f32 with scales), decoded in
    registers, on the schedule :func:`gather_schedule` picks from ``P`` —
    counterpart of ``gather_rerank_topk_pallas_blocked``. It returns bit for
    bit what the f32 kernel returns over the decoded table;
  * ``gather_rerank_topk_warp_cuda`` (same source): the one-warp schedule
    alone for every stored type, the bit reference of the split schedule
    for the tests. No query path reaches it.

With ``delta=`` (a mutable index's delta segment) each launches its
two-segment entry, whose ids address the virtual ``[data; delta]`` table;
the two-segment entries count their launches apart, one per call whether
the call made one launch or two. The plain versions are
``repro_torch.kernels.ref.gather_rerank_topk`` and, with a delta,
``gather_rerank_topk_segmented``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels._build import GATHER_RERANK as KERNEL
from repro_torch.kernels._build import GATHER_RERANK_BLOCKED as BLOCKED_KERNEL
from repro_torch.kernels._build import GATHER_RERANK_BLOCKED_TWO_SEG as BLOCKED_TWO_SEG_KERNEL
from repro_torch.kernels._build import GATHER_RERANK_TWO_SEG as TWO_SEG_KERNEL
from repro_torch.kernels._build import GATHER_RERANK_WARP as WARP_KERNEL
from repro_torch.kernels._build import require, stream_of

SMEM_LIMIT = 227 * 1024
# The schedules of csrc/gather_rerank.cuh
WARPS = 4  # queries per block of the one-warp-per-query schedule
SPLIT_WARPS = 8  # warps per block of the split schedule: one query, one slot range
MIN_GROUPS_PER_WARP = 4  # fewest 32-slot groups a warp of a split walks
WARP_SCHEDULE = 0  # gather_schedule's answer for one warp per query
STORED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # codes of the C launch


def gather_splits(b: int, P: int, sm_count: int, min_blocks: int) -> int:
    """The number of slot splits ``S`` of the split schedule for ``b``
    queries of ``P`` slots on a card of ``sm_count`` SMs, for a kernel
    instantiation whose registers allow ``min_blocks`` blocks per SM (its
    ``__launch_bounds__`` minimum, read from the library: :func:`f32_splits`,
    :func:`stored_schedule`).

    A block owns one (query, split). ``b`` blocks fill the card when they
    reach ``min_blocks`` per SM; below that each query's slots are cut into
    up to ``min_blocks * sm_count // b`` contiguous ranges, so one wave of
    (b, S) blocks fills the card, but never so many that a warp of a split
    walks fewer than ``MIN_GROUPS_PER_WARP`` 32-slot groups. The ranges are
    whole groups, ``ceil(groups / S)`` each, and ``S`` is then trimmed so
    that none is empty."""
    groups = -(-P // 32)
    if groups == 0 or b <= 0:
        return 1
    fill = min_blocks * sm_count // b
    most = groups // (SPLIT_WARPS * MIN_GROUPS_PER_WARP)
    S = max(1, min(fill, most))
    per = -(-groups // S)
    return -(-groups // per)


def gather_schedule(b: int, P: int, sm_count: int, min_blocks: int) -> int:
    """The stored-type kernel's schedule for ``b`` queries of ``P`` slots:
    ``WARP_SCHEDULE`` (0, one warp per query, ``WARPS`` queries a block)
    when a query has fewer 32-slot groups than a split block has warps —
    the rest of the block would sit idle, as over the screen's survivors —
    else the split schedule's ``S`` (:func:`gather_splits`, >= 1)."""
    if -(-P // 32) < SPLIT_WARPS:
        return WARP_SCHEDULE
    return gather_splits(b, P, sm_count, min_blocks)


def f32_splits(data: torch.Tensor, ids: torch.Tensor, delta: torch.Tensor | None = None) -> int:
    """The split count ``S`` of :func:`gather_rerank_topk_cuda` over these
    inputs: :func:`gather_splits` with the blocks per SM of the kernel the
    launch runs, as its library states it for these tables."""
    b, P = ids.shape
    blocks = KERNEL.lib().gather_rerank_split_blocks(
        data.data_ptr(), None if delta is None else delta.data_ptr(), data.shape[1])
    return gather_splits(b, P, _sm_count(data.device), blocks)


def stored_schedule(data: torch.Tensor, ids: torch.Tensor, scales: torch.Tensor | None = None,
                    delta: torch.Tensor | None = None) -> int:
    """The schedule of :func:`gather_rerank_topk_blocked_cuda` over these
    inputs: :func:`gather_schedule` with the blocks per SM of the split
    kernel the launch would run (they depend on the stored type, the scales
    and the layout the library picks from ``d`` and the alignment), as its
    library states it."""
    b, P = ids.shape
    blocks = BLOCKED_KERNEL.lib().gather_rerank_blocked_split_blocks(
        data.data_ptr(), None if delta is None else delta.data_ptr(),
        STORED_DTYPES[data.dtype], int(scales is not None), data.shape[1])
    return gather_schedule(b, P, _sm_count(data.device), blocks)


@functools.cache
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_args(data, ids, queries, weights, k, smem: int) -> None:
    """Device, dtype, shape and shared-memory checks common to the wrappers;
    ``smem`` is the bytes of shared memory one block of the launch takes."""
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


def split_smem(d: int, k: int, scaled: bool) -> int:
    """Shared memory of one split block: q, w (and the scales), SPLIT_WARPS
    lists of k (dist, slot), the merge's SPLIT_WARPS list heads."""
    return 4 * ((3 if scaled else 2) * _dpad(d) + 2 * SPLIT_WARPS * k + SPLIT_WARPS)


def warp_smem(d: int, k: int, scaled: bool) -> int:
    """Shared memory of one one-warp block: per warp q, w (and the scales)
    and a list of k (dist, id)."""
    return 4 * WARPS * ((3 if scaled else 2) * _dpad(d) + 2 * k)


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


def _split_scratch(b: int, S: int, k: int, dev) -> tuple:
    """Pointers of the (b, S, k) (dist, slot) scratch the merge launch reads
    with S > 1, and the tensors that hold it; NULLs without a merge."""
    if S <= 1:
        return (None, None), ()
    part_d = torch.empty((b, S, k), dtype=torch.float32, device=dev)
    part_s = torch.empty((b, S, k), dtype=torch.int32, device=dev)
    return (part_d.data_ptr(), part_s.data_ptr()), (part_d, part_s)


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
    _check_args(data, ids, queries, weights, k, smem=split_smem(d, k, scaled=False))
    b, P = ids.shape
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    S = f32_splits(data, ids, delta)
    part_ptrs, _scratch = _split_scratch(b, S, k, dev)
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


def _stored_args(name, data, scales, delta):
    """Checks of a stored-type table, its decode scales and its delta (cast
    to the table's dtype, which is returned)."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    if data.dtype not in STORED_DTYPES:
        raise TypeError(f"data must be one of {list(STORED_DTYPES)}, got {data.dtype}")
    require(data, "data", data.dtype, 2, dev)
    if scales is not None:
        require(scales, "scales", torch.float32, 1, dev)
        if scales.shape[0] != data.shape[1]:
            raise ValueError(f"scales must be ({data.shape[1]},), got {tuple(scales.shape)}")
    return _delta_arg(data, delta)


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
    and the two-segment entry launches. The schedule is
    :func:`gather_schedule`'s: one warp per query, or ``S`` splits (with
    ``S > 1`` a (b, S, k) scratch holds the splits' lists for the merge)."""
    delta = _stored_args("gather_rerank_topk_blocked_cuda", data, scales, delta)
    dev = data.device
    require(ids, "ids", torch.int32, 2, dev)  # its shape picks the schedule
    n, d = data.shape
    b, P = ids.shape
    scaled = scales is not None
    S = stored_schedule(data, ids, scales, delta)
    smem = warp_smem(d, k, scaled) if S == WARP_SCHEDULE else split_smem(d, k, scaled)
    _check_args(data, ids, queries, weights, k, smem=smem)
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    part_ptrs, _scratch = _split_scratch(b, S, k, dev)
    kernel = BLOCKED_KERNEL if delta is None else BLOCKED_TWO_SEG_KERNEL
    lib = kernel.lib()
    scales_ptr = scales.data_ptr() if scaled else None
    with torch.cuda.device(dev):
        kernel.launches += 1
        if delta is None:
            err = lib.gather_rerank_blocked_launch(
                data.data_ptr(), STORED_DTYPES[data.dtype], scales_ptr,
                ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *part_ptrs,
                n, d, b, P, k, S,
                stream_of(data),
            )
        else:
            err = lib.gather_rerank_blocked2_launch(
                data.data_ptr(), delta.data_ptr(), STORED_DTYPES[data.dtype], scales_ptr,
                ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
                out_d.data_ptr(), out_i.data_ptr(), *part_ptrs,
                n, delta.shape[0], d, b, P, k, S,
                stream_of(data),
            )
    kernel.check(err, f"{kernel.name} launch")
    return out_d, out_i


def gather_rerank_topk_warp_cuda(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    delta: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The one-warp-per-query schedule on its own, with the contract of
    :func:`gather_rerank_topk_blocked_cuda` for every stored type (f32
    without scales too): the bit reference that the split schedule of both
    kernels is held to. No query path calls it."""
    delta = _stored_args("gather_rerank_topk_warp_cuda", data, scales, delta)
    dev = data.device
    n, d = data.shape
    _check_args(data, ids, queries, weights, k, smem=warp_smem(d, k, scales is not None))
    b, P = ids.shape
    out_d = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    if b == 0:
        return out_d, out_i
    lib = WARP_KERNEL.lib()
    with torch.cuda.device(dev):
        WARP_KERNEL.launches += 1
        err = lib.gather_rerank_warp_launch(
            data.data_ptr(), None if delta is None else delta.data_ptr(),
            STORED_DTYPES[data.dtype], None if scales is None else scales.data_ptr(),
            ids.data_ptr(), queries.data_ptr(), weights.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(),
            n, 0 if delta is None else delta.shape[0], d, b, P, k,
            stream_of(data),
        )
    WARP_KERNEL.check(err, f"{WARP_KERNEL.name} launch")
    return out_d, out_i
