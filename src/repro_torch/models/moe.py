"""Mixture-of-Experts (top-1 routing, llama4-style).

Counterpart of ``repro.models.moe``'s single-controller path
(``moe_ffn_gspmd``), op for op in plain PyTorch. Capacity-based sorted
dispatch with static shapes:

  1. route: top-1 expert per token (``argmax``: ties go to the lower id, in
     both packages) and its sigmoid gate (llama4 convention);
  2. a stable sort of the tokens by expert id; each token's slot in its
     expert from the one-hot counts' exclusive cumsum;
  3. a scatter-add into an (E, C, dm) buffer, C = capacity_factor * T/E + 1:
     overflow tokens are dropped — each adds 0 at its expert's slot C-1, so
     every slot holds one token plus zeros and the sum is exact in any order
     (the gate contribution of a dropped token is zero; the shared expert
     still sees it);
  4. the batched SwiGLU experts on (E, C, dm);
  5. the gather back, the inverse permutation, the gate, and the
     always-on shared expert.

The reference's ``moe_impl="ep_shardmap"`` and ``"a2a_shardmap"`` are
``shard_map`` programs over a device mesh whose own tests fail under the
reference's jax (ROADMAP.md Queue C item 2), so they have no ground truth
here: ``moe_ffn`` refuses them, naming ROADMAP.md Queue A item 14d, where the
mesh tooling is decided. ``moe_specs`` (PartitionSpec trees) waits there too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import not_ported
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers, mlp

MESH_IMPLS_ITEM = "Queue A item 14d"


def init_moe(generator, cfg: ModelConfig, mcfg: MoEConfig, dtype) -> dict:
    dm, dff, E = cfg.d_model, mcfg.d_ff_expert, mcfg.n_experts
    std_in, std_out = dm**-0.5, dff**-0.5
    p = {
        "router": layers.init_linear(generator, dm, E, dtype, std=0.02),
        "experts": {
            "w_up": layers.truncated_normal_init(generator, (E, dm, dff), std_in, dtype),
            "w_gate": layers.truncated_normal_init(generator, (E, dm, dff), std_in, dtype),
            "w_down": layers.truncated_normal_init(generator, (E, dff, dm), std_out, dtype),
        },
    }
    if mcfg.n_shared:
        p["shared"] = mlp.init_mlp(generator, dm, mcfg.d_ff_expert * mcfg.n_shared, "swiglu",
                                   dtype)
    return p


def _capacity(T: int, E: int, factor: float) -> int:
    c = int(factor * T / E) + 1
    return max(8, min(c, T))


def check_impl(cfg: ModelConfig) -> None:
    """Raise ``not_ported`` for a ``moe_impl`` other than ``"gspmd"``."""
    if cfg.moe_impl != "gspmd":
        raise not_ported(f"{cfg.name}: moe_impl={cfg.moe_impl!r} (a shard_map mesh program)",
                         MESH_IMPLS_ITEM)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, mcfg: MoEConfig) -> torch.Tensor:
    """x (B, S, dm) -> (B, S, dm). Top-1 routed + shared expert."""
    check_impl(cfg)
    return moe_ffn_gspmd(params, x, cfg, mcfg)


def moe_ffn_gspmd(params: dict, x: torch.Tensor, cfg: ModelConfig,
                  mcfg: MoEConfig) -> torch.Tensor:
    """The sorted capacity dispatch (the reference's paper-faithful path)."""
    B, S, dm = x.shape
    E = mcfg.n_experts
    T = B * S
    C = _capacity(T, E, mcfg.capacity_factor)
    xf = x.reshape(T, dm)

    router_logits = layers.linear(params["router"], xf).float()  # (T, E)
    expert_idx = torch.argmax(router_logits, dim=-1)  # (T,) ties to the lower id
    gate = torch.sigmoid(torch.amax(router_logits, dim=-1))  # (T,) llama4 top-1 gate

    # --- sorted capacity dispatch -------------------------------------------
    sort_idx = torch.argsort(expert_idx, stable=True)  # (T,)
    sorted_expert = expert_idx[sort_idx]
    counts = torch.sum(F.one_hot(expert_idx, E), dim=0)  # (E,)
    offsets = torch.cumsum(counts, dim=0) - counts  # exclusive
    pos_in_expert = torch.arange(T, device=x.device) - offsets[sorted_expert]  # (T,)
    keep = pos_in_expert < C
    safe_pos = torch.where(keep, pos_in_expert, C - 1)

    xs = xf[sort_idx] * keep[:, None].to(x.dtype)
    buf = torch.zeros((E, C, dm), dtype=x.dtype, device=x.device).index_put(
        (sorted_expert, safe_pos), xs, accumulate=True)  # dropped tokens add 0 at slot C-1

    # --- expert FFN (batched over experts) ----------------------------------
    we = params["experts"]
    up = torch.einsum("ecd,edf->ecf", buf, we["w_up"].to(x.dtype))
    gt = torch.einsum("ecd,edf->ecf", buf, we["w_gate"].to(x.dtype))
    h = F.silu(gt) * up
    down = torch.einsum("ecf,efd->ecd", h, we["w_down"].to(x.dtype))  # (E, C, dm)

    # --- combine: gather back, unsort, gate ---------------------------------
    gathered = down[sorted_expert, safe_pos] * keep[:, None].to(x.dtype)  # sorted order
    inv = torch.argsort(sort_idx)
    out = gathered[inv] * gate[:, None].to(x.dtype)

    if "shared" in params:
        out = out + mlp.mlp(params["shared"], xf, "swiglu")
    return out.reshape(B, S, dm)


def aux_load_balance_loss(router_logits: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary (exposed for the training loss)."""
    probs = torch.softmax(router_logits, dim=-1)
    expert_idx = torch.argmax(router_logits, dim=-1)
    frac_tokens = torch.mean(F.one_hot(expert_idx, E).to(probs.dtype), dim=0)
    frac_probs = torch.mean(probs, dim=0)
    return E * torch.sum(frac_tokens * frac_probs)
