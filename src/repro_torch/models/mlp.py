"""Feed-forward blocks: SwiGLU / GeGLU / GELU.

Counterpart of ``repro.models.mlp`` (its tensor-parallel sharding hint has
no counterpart on one card). JAX's ``gelu(approximate=True)`` is torch's
``gelu(approximate="tanh")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_mlp(generator, d_model: int, d_ff: int, activation: str, dtype) -> dict:
    p = {
        "w_up": layers.init_linear(generator, d_model, d_ff, dtype),
        "w_down": layers.init_linear(generator, d_ff, d_model, dtype, std=d_ff**-0.5),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = layers.init_linear(generator, d_model, d_ff, dtype)
    return p


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = layers.linear(params["w_up"], x)
    if activation == "swiglu":
        h = F.silu(layers.linear(params["w_gate"], x)) * up
    elif activation == "geglu":
        h = F.gelu(layers.linear(params["w_gate"], x), approximate="tanh") * up
    else:  # gelu
        h = F.gelu(up, approximate="tanh")
    return layers.linear(params["w_down"], h)
