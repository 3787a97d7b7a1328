"""Shared neural net layers: norms, rotary embeddings, initializers.

Counterpart of ``repro.models.layers``. Functional style, as there:
``init_*`` build parameter trees (nested dicts of tensors) and apply
functions are plain functions of (params, inputs). The reference's
``*_specs`` (PartitionSpec trees) have no counterpart: the port runs one
process per card.

Casts follow the reference op for op, since they fix the bits: ``linear``
casts its weight to the input's dtype on every call and ``embed`` casts the
whole table before indexing it. Where the reference asks XLA for an f32
result of bf16 operands (``preferred_element_type=float32``), the port
upcasts both operands to f32 and multiplies in f32: the products of bf16
values are exact in f32, so this is XLA's f32 sum of exact products, never a
bf16 product rounded afterwards.
"""

from __future__ import annotations

import torch


def init_device(generator: torch.Generator | None) -> torch.device:
    """Where ``init_*`` put their tensors: the generator's device, or the meta
    device for ``generator=None`` (shapes and dtypes only, no memory)."""
    return torch.device("meta") if generator is None else generator.device


def truncated_normal_init(generator: torch.Generator | None, shape, std: float,
                          dtype) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-2, 2], drawn in f32 from
    ``generator`` on its device, then cast to ``dtype`` (a meta tensor for
    ``generator=None``). The reference draws with ``jax.random``, which torch
    cannot replay: parity goes through ``models.convert.params_from_jax``."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=dtype, device="meta")
    t = torch.empty(tuple(shape), dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=generator)
    return (std * t).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(dim: int, dtype, device=None) -> dict:
    return {"scale": torch.zeros((dim,), dtype=dtype, device=device)}  # gemma (1 + scale) form


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (RoPE + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in f32 as the reference's."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)  # a Python base: no host-to-device copy


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Split-half rotation of x (B, S, H, D) by angles (B, S, D/2), in f32."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) int -> rotated x (split-half convention)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    return _rotate(x, angles)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL M-RoPE. x (B, S, H, D); positions_3d (3, B, S) (t, h, w) grids.

    The D/2 frequency slots are partitioned into ``sections`` (t, h, w); each
    section rotates by its own position grid. sum(sections) == D/2.
    """
    D = x.shape[-1]
    half = D // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} must sum to head_dim/2 = {half}")
    freqs = rope_freqs(D, theta, device=x.device)  # (D/2,)
    # per-slot positions (B, S, D/2): section i's slots take grid i
    pos_sel = torch.cat([positions_3d[i, ..., None].expand(*positions_3d.shape[1:], n)
                         for i, n in enumerate(sections)], dim=-1).float()
    return _rotate(x, pos_sel * freqs)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def init_embed(generator, vocab: int, d_model: int, dtype) -> dict:
    return {"table": truncated_normal_init(generator, (vocab, d_model), 0.02, dtype)}


def embed(params: dict, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # the whole table is cast before the lookup, as the reference does
    return params["table"].to(compute_dtype)[tokens.long()]


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result, as XLA's ``preferred_element_type=f32``:
    both operands upcast to f32 (exact for bf16), summed in f32."""
    return torch.matmul(a.float(), b.float())


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    """logits = x @ table^T (tied), f32; callers may cast/softcap."""
    table = params["table"].to(x.dtype)
    return f32_product(x, table.T)


def init_linear(generator, d_in: int, d_out: int, dtype, std: float | None = None) -> dict:
    std = std if std is not None else d_in**-0.5
    return {"w": truncated_normal_init(generator, (d_in, d_out), std, dtype)}


def linear(params: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
