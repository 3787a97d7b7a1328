"""Dispatch of the kernel entry points by tensor device.

Counterpart of ``repro.kernels.ops``. Policy:

  * a CUDA tensor launches the hand-written CUDA kernel — or raises; it is
    never routed to the plain version, and no ``try`` falls back when the
    build or the launch fails;
  * a CPU tensor takes the plain PyTorch version (``kernels/ref.py``);
  * ``force="plain"`` runs the plain version on any device. It exists for
    the tests, which hold each kernel against its plain version on the card,
    and for ``chip_smoke.py``, which does so on the inputs its paths capture;
    the engine never passes it.

The CUDA wrappers import nothing CUDA-specific until they run, so this
module imports on machines without a GPU or ``nvcc``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

FORCES = (None, "plain")


def _use_kernel(t: torch.Tensor, force: str | None) -> bool:
    if force not in FORCES:
        raise ValueError(f"force must be one of {FORCES}, got {force!r}")
    if force == "plain":
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def alsh_project(
    levels: torch.Tensor,
    folded: torch.Tensor,
    weights: torch.Tensor | None = None,
    force: str | None = None,
    tiled: torch.Tensor | None = None,
) -> torch.Tensor:
    """§4.2.3 hash projection: (n, d) levels × (H, d, M+1) tables -> (n, H).
    ``tiled`` is the kernel's relayout of ``folded`` (``PrefixTables.tiled``);
    the kernel makes it when it is not given, the plain version ignores it."""
    if _use_kernel(levels, force):
        from repro_torch.kernels.alsh_project import alsh_project_cuda

        return alsh_project_cuda(levels, folded, weights, tiled)
    return ref.alsh_project(levels, folded, weights)


def wl1_scan(
    data: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    force: str | None = None,
) -> torch.Tensor:
    """Exact brute-force scan: (n, d) × (b, d) -> (b, n) (materializing)."""
    if _use_kernel(data, force):
        from repro_torch.kernels.wl1_distance import wl1_scan_cuda

        return wl1_scan_cuda(data, queries, weights)
    return ref.wl1_scan(data, queries, weights)


def wl1_rerank(
    pts: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    force: str | None = None,
) -> torch.Tensor:
    """Candidate re-rank: (b, C, d) × (b, d) -> (b, C)."""
    if _use_kernel(pts, force):
        from repro_torch.kernels.wl1_distance import wl1_rerank_cuda

        return wl1_rerank_cuda(pts, queries, weights)
    return ref.wl1_rerank(pts, queries, weights)


def wl1_scan_topk(
    data: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    force: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming exact k-NN scan: (n, d) × (b, d) -> ((b, k), (b, k)) without
    the (b, n) distance matrix."""
    if _use_kernel(data, force):
        from repro_torch.kernels.wl1_topk import wl1_scan_topk_cuda

        return wl1_scan_topk_cuda(data, queries, weights, k)
    return ref.wl1_scan_topk(data, queries, weights, k)


def multiprobe_keys(
    proj_lk: torch.Tensor,
    n_probes: int,
    max_flips: int,
    force: str | None = None,
) -> torch.Tensor:
    """Query-directed multiprobe keys: (b, L, K) raw projections -> (b, L, P)
    int32 probe keys, most likely first (P is ``n_probes`` clamped to the
    flip subsets of at most ``max_flips`` bits)."""
    if _use_kernel(proj_lk, force):
        from repro_torch.kernels.multiprobe_keys import multiprobe_keys_cuda

        return multiprobe_keys_cuda(proj_lk, n_probes, max_flips)
    return ref.multiprobe_keys(proj_lk, n_probes, max_flips)


def dedupe_candidates(
    cand: torch.Tensor,
    n: int,
    force: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Candidate dedupe: (b, P) ids (>= n ⇒ padding) -> ((b, P) int32, each
    row's distinct ids below n ascending, then ``n``; (b,) int32 counts)."""
    if _use_kernel(cand, force):
        from repro_torch.kernels.dedupe_candidates import dedupe_candidates_cuda

        return dedupe_candidates_cuda(cand, n)
    return ref.dedupe_candidates(cand, n)


def gather_rerank_topk(
    data: torch.Tensor,
    ids: torch.Tensor,
    queries: torch.Tensor,
    weights: torch.Tensor,
    k: int,
    scales: torch.Tensor | None = None,
    delta: torch.Tensor | None = None,
    force: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused ALSH probe tail: (n, d) table + (b, P) candidate ids (>= n ⇒
    invalid) -> top-k ((b, k) dists, (b, k) ids), no (b, P, d) gather.

    ``data`` is f32 or a quantized payload (bf16/int8) with optional (d,)
    ``scales``; rows are decoded per gathered row. With ``delta`` (cap, d)
    — a mutable index's delta segment, cast to ``data``'s dtype — ids
    address the virtual ``[data; delta]`` table (>= n + cap ⇒ invalid),
    which is never concatenated. On the card an f32 table without scales
    launches the f32 kernel and any other table the quantized kernel, each
    in its two-segment form when ``delta`` is given (the reference's
    routing)."""
    if _use_kernel(data, force):
        from repro_torch.kernels import gather_rerank

        if data.dtype == torch.float32 and scales is None:
            return gather_rerank.gather_rerank_topk_cuda(data, ids, queries, weights, k,
                                                         delta=delta)
        return gather_rerank.gather_rerank_topk_blocked_cuda(
            data, ids, queries, weights, k, scales=scales, delta=delta
        )
    if delta is not None:
        return ref.gather_rerank_topk_segmented(data, delta, ids, queries, weights, k,
                                                scales=scales)
    return ref.gather_rerank_topk(data, ids, queries, weights, k, scales=scales)

