"""Mixture-of-Experts (top-1 routing, llama4-style) with expert parallelism.

Counterpart of ``repro.models.moe``, op for op in plain PyTorch.
Capacity-based sorted dispatch with static shapes:

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

``moe_impl`` picks one of three impls, as in the reference:

  * ``"gspmd"`` — the dispatch above over all tokens and experts;
  * ``"ep_shardmap"`` — explicit expert parallelism: each EP rank dispatches
    its batch shard's tokens to its own E/ep experts (``E_offset``) and a
    sum over the ranks (``psum``) combines them;
  * ``"a2a_shardmap"`` — each rank routes its own tokens, sends each to the
    rank owning its expert (per-peer capacity Cp), runs its local experts on
    what it received (per-expert capacity C2) and sends the outputs back.

With no mesh active (``models.sharding.use_mesh``), or a mesh without the
EP axis, both mesh impls return ``moe_ffn_gspmd``'s answer, as the
reference's do. Under a mesh one controller runs every (batch shard, EP
rank) body of the reference's ``shard_map`` at once, with the ranks as
leading tensor dims: ``psum`` is a sum over the EP dim, ``all_gather`` and
``psum_scatter`` a concatenation and a split of the batch blocks, and
``all_to_all`` a transpose of the (ep, ep, Cp, dm) send buffers. The
capacities follow the reference's formulas, the greedy batch-axis prefix
included.

One behaviour of the reference is kept on purpose: its a2a send metadata is
a scatter-set where every dropped token writes -1 at its peer's last slot
after the kept token there (XLA's CPU scatter applies updates in order), so
when a peer overflows, the token in its slot Cp-1 loses its routed output
too. The port writes that outcome directly, with no duplicate index.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.models import layers, mlp
from repro_torch.models.sharding import BATCH, EP, FSDP, P, get_mesh, resolve_entry


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


def moe_specs(mcfg: MoEConfig, impl: str = "gspmd") -> dict:
    # Both impls STORE experts 2-D sharded (EP x FSDP), as the reference's
    experts = {
        "w_up": P(EP, FSDP, None),
        "w_gate": P(EP, FSDP, None),
        "w_down": P(EP, None, FSDP),
    }
    p = {"router": layers.linear_specs(None, None), "experts": experts}
    if mcfg.n_shared:
        p["shared"] = mlp.mlp_specs("swiglu")
    return p


def _capacity(T: int, E: int, factor: float) -> int:
    c = int(factor * T / E) + 1
    return max(8, min(c, T))


# ---------------------------------------------------------------------------
# The per-rank bodies (any leading dims: one per rank of a mesh)
# ---------------------------------------------------------------------------


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index: x (..., T, d), idx (..., T')."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def _slots(local: torch.Tensor, E: int, C: int):
    """The sorted capacity dispatch of local expert ids (..., T) in [0, E]
    (E: no expert of this rank): the stable sort, each sorted token's flat
    slot e * C + pos in the (E, C) buffer, and whether it is kept."""
    T = local.shape[-1]
    sort_idx = torch.argsort(local, dim=-1, stable=True)
    sorted_expert = torch.take_along_dim(local, sort_idx, dim=-1)
    counts = torch.sum(F.one_hot(local, E + 1), dim=-2)
    offsets = torch.cumsum(counts, dim=-1) - counts  # exclusive
    pos = torch.arange(T, device=local.device) - torch.take_along_dim(offsets, sorted_expert,
                                                                      dim=-1)
    keep = (pos < C) & (sorted_expert < E)
    safe_pos = torch.where(keep, pos, C - 1)
    safe_exp = torch.clamp_max(sorted_expert, E - 1)
    return sort_idx, safe_exp * C + safe_pos, keep


def _experts(buf: torch.Tensor, we: dict, dtype) -> torch.Tensor:
    """The SwiGLU experts on (..., E, C, dm) against (..., E, dm, dff) stacks."""
    up = torch.matmul(buf, we["w_up"].to(dtype))
    gt = torch.matmul(buf, we["w_gate"].to(dtype))
    return torch.matmul(F.silu(gt) * up, we["w_down"].to(dtype))


def _dispatch(xf: torch.Tensor, local: torch.Tensor, we: dict, E: int, C: int) -> torch.Tensor:
    """Tokens xf (..., T, dm) with local expert ids (..., T) in [0, E]
    through the (E, C) capacity buffer and the experts; (..., T, dm) in
    token order, zeros for tokens of no local expert or dropped."""
    *lead, T, dm = xf.shape
    sort_idx, slot, keep = _slots(local, E, C)
    keepf = keep[..., None].to(xf.dtype)
    xs = _take(xf, sort_idx) * keepf
    # every slot holds one kept token plus zeros: the sum is exact in any order
    buf = torch.zeros((*lead, E * C, dm), dtype=xf.dtype, device=xf.device).scatter_add(
        -2, slot[..., None].expand(xs.shape), xs)
    down = _experts(buf.unflatten(-2, (E, C)), we, xf.dtype).flatten(-3, -2)
    out_sorted = _take(down, slot) * keepf
    return _take(out_sorted, torch.argsort(sort_idx, dim=-1))


def _dispatch_compute_combine(xf, router_logits, we, E, C, E_offset=0):
    """Shared core: sorted capacity dispatch -> expert FFN -> combine.

    xf (..., T, dm); router_logits (..., T, E_total) float32; we holds
    (..., E, dm, dff) weight stacks for the E LOCAL experts starting at
    global id E_offset (an int, or a tensor of the leading shape). Tokens
    routed outside [E_offset, E_offset+E) are dropped here (handled by
    other ranks under EP). Returns (..., T, dm) routed output (gated).
    """
    expert_global = torch.argmax(router_logits, dim=-1)  # (..., T)
    gate = torch.sigmoid(torch.amax(router_logits, dim=-1))  # (..., T)
    if isinstance(E_offset, torch.Tensor):
        E_offset = E_offset[..., None]
    local = expert_global - E_offset
    mine = (local >= 0) & (local < E)
    local = torch.where(mine, local, E)  # foreign tokens -> virtual expert E
    return _dispatch(xf, local, we, E, C) * gate[..., None].to(xf.dtype)


def _dispatch_by_ids(xf, local_ids, we, E, C):
    """Expert FFN for tokens with PRE-ASSIGNED local expert ids (a2a receive
    side). local_ids (..., T) in [0, E) or -1 (invalid/padding). Returns
    (..., T, dm) outputs (zeros for invalid/dropped)."""
    return _dispatch(xf, torch.where(local_ids >= 0, local_ids, E), we, E, C)


# ---------------------------------------------------------------------------
# The mesh impls
# ---------------------------------------------------------------------------


def _ep_layout(mesh, B: int, E: int):
    """(ep axis, ep, E_local, batch axes, their size product) of ``mesh``
    for a batch of B: the batch axes are the greedy prefix of the policy's
    whose product divides B (mirror of ``sharding.sanitize_spec``)."""
    ep_axis = resolve_entry(EP)
    ep = mesh.shape[ep_axis]
    if E % ep:
        raise ValueError(f"{E} experts do not split over an EP axis of {ep}")
    batch_axes, prod = [], 1
    for a in resolve_entry(BATCH) or ():
        if a in mesh.axis_names and B % (prod * mesh.shape[a]) == 0:
            batch_axes.append(a)
            prod *= mesh.shape[a]
    return ep_axis, ep, E // ep, tuple(batch_axes), prod


def _ranked_experts(we: dict, ep: int) -> dict:
    """The expert stacks (E, …) as (ep, E/ep, …): rank r's local experts."""
    return {k: v.reshape(ep, v.shape[0] // ep, *v.shape[1:]) for k, v in we.items()}


def _add_shared(params: dict, routed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if "shared" not in params:
        return routed
    B, S, dm = x.shape
    return routed + mlp.mlp(params["shared"], x.reshape(B * S, dm), "swiglu").reshape(B, S, dm)


def moe_ffn_ep_shardmap(params: dict, x: torch.Tensor, cfg: ModelConfig,
                        mcfg: MoEConfig) -> torch.Tensor:
    """Explicit expert parallelism.

    Megatron layout (the EP axis not a batch axis): every EP rank of a
    batch shard dispatches the SAME tokens to its local E/ep experts, and a
    sum over the ranks combines the partial outputs. dp_over_model (the EP
    axis a batch axis): the EP ranks' token blocks are first concatenated
    (``all_gather``), and each rank keeps its own block of the sum
    (``psum_scatter``).
    """
    mesh = get_mesh()
    if mesh is None or resolve_entry(EP) not in mesh.axis_names:
        return moe_ffn_gspmd(params, x, cfg, mcfg)
    B, S, dm = x.shape
    E = mcfg.n_experts
    ep_axis, ep, E_local, batch_axes, _ = _ep_layout(mesh, B, E)
    gather_tokens = ep_axis in batch_axes
    # tokens visible to one rank's dispatch = batch shard WITHOUT the ep axis
    n_batch_shards = 1
    for a in batch_axes:
        if a != ep_axis:
            n_batch_shards *= mesh.shape[a]
    T = max(B // n_batch_shards, 1) * S
    C = _capacity(T, E, mcfg.capacity_factor)

    # a group's tokens (its EP blocks concatenated, when the EP axis, last in
    # the policy, is a batch axis) are adjacent rows of the batch
    G = n_batch_shards
    xg = x.reshape(G, -1, dm)
    logits = (xg @ params["router"]["w"].to(xg.dtype)).float()  # (G, Tg, E)
    offsets = torch.arange(ep, device=x.device) * E_local
    routed = _dispatch_compute_combine(
        xg[:, None].expand(G, ep, *xg.shape[1:]), logits[:, None].expand(G, ep, *logits.shape[1:]),
        _ranked_experts(params["experts"], ep), E_local, C, E_offset=offsets)
    combined = routed.sum(dim=1)  # psum over the EP ranks: one nonzero term a token
    return _add_shared(params, combined.reshape(x.shape), x)


def moe_ffn_a2a_shardmap(params: dict, x: torch.Tensor, cfg: ModelConfig,
                         mcfg: MoEConfig) -> torch.Tensor:
    """All-to-all expert parallelism (tokens batch-sharded over the EP axis
    too, which needs dp_over_model): each rank routes its tokens, sends each
    to the rank owning its expert (at most Cp a peer), computes its local
    experts on what it received (at most C2 an expert) and sends the outputs
    back. Falls back to ``moe_ffn_ep_shardmap`` when the EP axis is not a
    batch axis, as the reference's."""
    mesh = get_mesh()
    if mesh is None or resolve_entry(EP) not in mesh.axis_names:
        return moe_ffn_gspmd(params, x, cfg, mcfg)
    B, S, dm = x.shape
    E = mcfg.n_experts
    ep_axis, ep, E_local, batch_axes, prod = _ep_layout(mesh, B, E)
    if ep_axis not in batch_axes:
        # tokens are replicated over EP: a2a degenerates — use gather-EP path
        return moe_ffn_ep_shardmap(params, x, cfg, mcfg)
    T_l = (B // prod) * S  # tokens per rank
    Cp = max(8, int(mcfg.capacity_factor * T_l / ep) + 1)  # per-peer slots
    C2 = max(8, int(mcfg.capacity_factor * ep * Cp / E_local) + 1)  # per-expert

    # shard_map's prod batch blocks are row-major over the batch axes, and the
    # policy lists the EP axis last: the ep blocks of a group are adjacent
    G = prod // ep
    xf = x.reshape(G, ep, T_l, dm)
    logits = (xf @ params["router"]["w"].to(xf.dtype)).float()
    expert_global = torch.argmax(logits, dim=-1)  # (G, ep, T_l)
    gate = torch.sigmoid(torch.amax(logits, dim=-1))
    target = torch.div(expert_global, E_local, rounding_mode="floor")  # owning rank

    # --- pack send buffers: (ep, Cp, dm) per rank + local-expert ids -------
    sidx, slot, keep = _slots(target, ep, Cp)
    keepf = keep[..., None].to(xf.dtype)
    xs = _take(xf, sidx) * keepf
    sbuf = torch.zeros((G, ep, ep * Cp, dm), dtype=xf.dtype, device=x.device).scatter_add(
        -2, slot[..., None].expand(xs.shape), xs)
    ids = torch.where(keep, torch.take_along_dim(expert_global, sidx, dim=-1) % E_local, -1)
    dummy = ep * Cp  # dropped tokens write a slot past the end, sliced off
    smeta = torch.full((G, ep, dummy + 1), -1, dtype=ids.dtype, device=x.device).scatter(
        -1, torch.where(keep, slot, dummy), ids)[..., :dummy].reshape(G, ep, ep, Cp)
    counts = torch.sum(F.one_hot(target, ep), dim=-2)  # (G, ep, ep) tokens a peer
    last = torch.where(counts > Cp, -1, smeta[..., Cp - 1])  # the reference's -1 there
    smeta = torch.cat([smeta[..., :Cp - 1], last[..., None]], dim=-1)

    # --- exchange, compute, exchange back --------------------------------
    def exchange(t):  # all_to_all: (G, src, dst, …) -> (G, dst, src, …)
        return t.transpose(1, 2).reshape(t.shape[0], ep, -1, *t.shape[4:])

    rbuf = exchange(sbuf.reshape(G, ep, ep, Cp, dm))
    rmeta = exchange(smeta)
    y = _dispatch_by_ids(rbuf, rmeta, _ranked_experts(params["experts"], ep), E_local, C2)
    ybuf = exchange(y.reshape(G, ep, ep, Cp, dm))  # (G, src, ep * Cp, dm)

    # --- unpack at source -------------------------------------------------
    back_sorted = _take(ybuf, slot) * keepf
    routed = _take(back_sorted, torch.argsort(sidx, dim=-1)) * gate[..., None].to(xf.dtype)
    return _add_shared(params, routed.reshape(x.shape), x)


def moe_ffn(params: dict, x: torch.Tensor, cfg: ModelConfig, mcfg: MoEConfig) -> torch.Tensor:
    """x (B, S, dm) -> (B, S, dm). Top-1 routed + shared expert (impl lever)."""
    if cfg.moe_impl == "a2a_shardmap":
        return moe_ffn_a2a_shardmap(params, x, cfg, mcfg)
    if cfg.moe_impl == "ep_shardmap":
        return moe_ffn_ep_shardmap(params, x, cfg, mcfg)
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
