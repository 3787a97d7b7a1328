"""CUDA wrapper of the multiprobe key enumeration (``csrc/multiprobe_keys.cu``).

Replaces no Pallas kernel: the reference computes query-directed probe keys
in jnp (``repro.core.families.ThetaFamily.multiprobe_keys``). The kernel
turns (b, L, K) projections into (b, L, P) keys in one launch, with no
subset table and no host work; the CUDA source carries the design note. The
plain version is ``repro_torch.kernels.ref.multiprobe_keys``.
"""

from __future__ import annotations

import torch

from repro_torch.core.families import n_flip_subsets
from repro_torch.kernels._build import MULTIPROBE_KEYS as KERNEL
from repro_torch.kernels._build import on_device, raw_stream, require

MAX_K = 31  # sign bits packed into one int32 key
REGISTER_LIST_MAX = 32  # the most probes a thread keeps in registers


def list_size(P: int) -> int:
    """The kernel's list for ``P`` probes: P's power-of-two ceiling, kept in
    registers, up to ``REGISTER_LIST_MAX``; 0 above it (a heap in device
    memory)."""
    return 1 << (P - 1).bit_length() if P <= REGISTER_LIST_MAX else 0


def multiprobe_keys_cuda(proj_lk: torch.Tensor, n_probes: int, max_flips: int) -> torch.Tensor:
    """proj_lk (b, L, K) f32 on a CUDA device -> (b, L, P) int32 probe keys,
    the query's own bucket first, then its flip subsets in increasing
    total |margin|, ties in ``flip_subsets`` order. P is ``n_probes``
    clamped to the subsets of at most ``max_flips`` of K bits."""
    dev = proj_lk.device
    if dev.type != "cuda":
        raise ValueError(f"multiprobe_keys_cuda needs a CUDA tensor, got {dev}")
    require(proj_lk, "proj_lk", torch.float32, 3, dev)
    b, L, K = proj_lk.shape
    if K > MAX_K:
        raise ValueError(f"multiprobe_keys_cuda: K={K} sign bits exceed one int32 key ({MAX_K})")
    if n_probes < 0 or max_flips < 0:
        raise ValueError(f"n_probes and max_flips must be >= 0, got {n_probes}, {max_flips}")
    pairs = b * L
    if pairs >= 2**31:
        raise ValueError(f"multiprobe_keys_cuda: b*L={pairs} (query, table) pairs exceed int32")
    P = min(n_probes, n_flip_subsets(K, max_flips))
    out = torch.empty((b, L, P), dtype=torch.int32, device=dev)
    if pairs == 0 or P == 0:
        return out
    size = list_size(P)
    scratch = torch.empty((3, P, pairs), dtype=torch.float32, device=dev) if size == 0 else None
    lib = KERNEL.lib()
    with on_device(dev):
        KERNEL.launches += 1
        err = lib.multiprobe_keys_launch(
            proj_lk.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            pairs, K, min(max_flips, K), P, size,
            raw_stream(dev),
        )
    KERNEL.check(err, "multiprobe_keys launch")
    return out
