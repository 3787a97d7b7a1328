"""Input builders: concrete batches (smoke/examples) and meta-tensor
stand-ins (dry run) for every (arch × shape-kind) cell.

Counterpart of ``repro.launch.specs``: the same keys, shapes, dtypes and
fills (``iota % 97`` for token-like leaves, 0.1 for embeddings, ``True``
masks, token 1 and ``pos_value`` for decode). The abstract form (the
reference's ``ShapeDtypeStruct``) is a tensor on the ``meta`` device; the
concrete form fills tensors on ``device`` (default: the CUDA card).

The modality frontends are stubs by assignment: [audio] provides precomputed
frame embeddings, [vlm] provides precomputed patch embeddings + M-RoPE grids.
"""

from __future__ import annotations

import math

import torch

from repro_torch.api.index import resolve_device
from repro_torch.configs.base import ModelConfig


def _mk(shape, dtype, concrete: bool, fill=0, device=None) -> torch.Tensor:
    if not concrete:
        return torch.empty(shape, dtype=dtype, device="meta")
    dev = resolve_device(device)
    if fill == "iota":
        return torch.arange(math.prod(shape), dtype=dtype, device=dev).reshape(shape) % 97
    return torch.full(shape, fill, dtype=dtype, device=dev)


def train_batch(cfg: ModelConfig, batch: int, seq: int, concrete: bool = False,
                device=None) -> dict:
    if cfg.frontend == "audio":
        return {
            "frames": _mk((batch, seq, cfg.frontend_dim), torch.float32, concrete, 0.1, device),
            "targets": _mk((batch, seq), torch.int32, concrete, "iota", device),
            "mask": _mk((batch, seq), torch.bool, concrete, True, device),
        }
    if cfg.frontend == "vision":
        nv = min(cfg.n_vision_tokens, seq // 2)  # clamp for tiny test seqs
        s_text = seq - nv
        return {
            "tokens": _mk((batch, s_text), torch.int32, concrete, "iota", device),
            "patches": _mk((batch, nv, cfg.frontend_dim), torch.float32, concrete, 0.1, device),
            "positions": _mk((3, batch, seq), torch.int32, concrete, "iota", device),
        }
    return {"tokens": _mk((batch, seq), torch.int32, concrete, "iota", device)}


def prefill_batch(cfg: ModelConfig, batch: int, seq: int, concrete: bool = False,
                  device=None) -> dict:
    b = train_batch(cfg, batch, seq, concrete, device)
    b.pop("targets", None)
    b.pop("mask", None)
    return b


def decode_batch(cfg: ModelConfig, batch: int, pos_value: int, concrete: bool = False,
                 device=None) -> dict:
    return {
        "token": _mk((batch,), torch.int32, concrete, 1, device),
        "pos": _mk((batch,), torch.int32, concrete, pos_value, device),
    }
