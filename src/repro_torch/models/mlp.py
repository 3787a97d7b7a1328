"""Feed-forward blocks: SwiGLU / GeGLU / GELU.

Counterpart of ``repro.models.mlp``, tensor-parallel over d_ff in its spec
tree (``mlp_specs``; the reference's sharding hint on the hidden
activation is ``maybe_shard``, the identity here). JAX's ``gelu(approximate=True)`` is torch's
``gelu(approximate="tanh")``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.models.sharding import FSDP, TP


def init_mlp(generator, d_model: int, d_ff: int, activation: str, dtype) -> dict:
    p = {
        "w_up": layers.init_linear(generator, d_model, d_ff, dtype),
        "w_down": layers.init_linear(generator, d_ff, d_model, dtype, std=d_ff**-0.5),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = layers.init_linear(generator, d_model, d_ff, dtype)
    return p


def mlp_specs(activation: str) -> dict:
    p = {
        "w_up": layers.linear_specs(FSDP, TP),
        "w_down": layers.linear_specs(TP, FSDP),
    }
    if activation in ("swiglu", "geglu"):
        p["w_gate"] = layers.linear_specs(FSDP, TP)
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
