"""Model assembly: layer patterns of scan units and a tail, three run modes.

Counterpart of ``repro.models.model``. Layer patterns: ``cfg.scan_unit`` is
a tuple of layer kinds repeated ``n_units`` times — its parameters stacked
along a leading (n_units) axis, as the reference's ``vmap``'d init lays
them out — followed by an explicit ``tail``. The reference runs the units
under ``lax.scan``; the port runs them in a Python loop over the stacked
parameters (each unit's slice is a view, not a copy) and stacks the units'
caches again at the end. Kinds:

  attn / local / global / chunked / global_nope — attention block (+ MLP)
     ... with "_moe" suffix → MoE FFN (``models.moe``) instead of dense MLP
  mamba2       — Mamba2 SSD block (``models.ssm``; no separate FFN)
  shared_attn  — attention + MLP with weights SHARED across occurrences
                 (``params["shared_block"]``, zamba2); per-occurrence KV
                 caches remain distinct.

Frontends: ``frontend="audio"`` maps ``batch["frames"]`` through
``frontend_proj`` and reads logits from ``head`` (masked-prediction CE over
``batch["targets"]``/``batch["mask"]``); ``frontend="vision"`` puts the
``vision_proj`` patch prefix before the token embeddings and rotates by the
``(3, B, S)`` M-RoPE ``batch["positions"]`` (LM loss on text positions only).
``encoder_only`` models prefill to full ``(B, S, V)`` logits and no caches.
``param_specs`` and ``cache_specs`` are the trees' PartitionSpecs
(``models.sharding``), the layout the dry run divides each leaf by.

Run modes:
  forward_train   — full-sequence forward + next-token (or masked) CE loss
  forward_prefill — full-sequence forward, returns per-layer caches + logits
  forward_decode  — one token against the caches

Training differentiates with ``torch.autograd`` through the same ops as
prefill (no forward op here writes in place). ``cfg.remat`` wraps each unit in a
non-reentrant ``torch.utils.checkpoint``, the reference's ``jax.checkpoint``
per scanned unit: with ``remat_policy="nothing"`` the unit's activations
are recomputed in the backward pass, with ``"dots"`` the outputs of its
weight products (``aten.mm``, jax's ``dots_with_no_batch_dims_saveable``)
are kept and the rest recomputed. The recomputation runs the same ops on
the same inputs, so remat changes no bit of the loss or the gradients.

Params are nested dicts of tensors with the reference's tree and leaf
shapes, so ``models.convert.params_from_jax`` hands the reference's over
one to one. ``init_tree`` draws the stacked unit leaves slice by slice into
tensors allocated once (``layers.DeferredDraws``), so its peak is the
parameters plus one f32 draw.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt_util

from repro_torch.api.index import as_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mlp, moe, ssm
from repro_torch.models.sharding import BATCH, FSDP, TP, P, spec_tree_map


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def _attn_kind(kind: str) -> str:
    return kind.removesuffix("_moe")


def _is_moe(kind: str) -> bool:
    return kind.endswith("_moe")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    """Params for one layer of the given kind (shared_attn → empty marker)."""
    if kind == "shared_attn":
        return {}
    dev = layers.init_device(generator)
    if kind == "mamba2":
        return {
            "ln1": layers.init_rmsnorm(cfg.d_model, dtype, dev),
            "mamba": ssm.init_mamba2(generator, cfg, cfg.ssm, dtype),
        }
    p = {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": attention.init_attention(generator, cfg, dtype),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if _is_moe(kind):
        p["ffn"] = moe.init_moe(generator, cfg, cfg.moe, dtype)
    else:
        d_ff = cfg.moe.d_ff_dense if cfg.moe is not None else cfg.d_ff
        p["ffn"] = mlp.init_mlp(generator, cfg.d_model, d_ff, cfg.activation, dtype)
    return p


def _block_specs(kind: str, cfg: ModelConfig) -> dict:
    if kind == "shared_attn":
        return {}
    if kind == "mamba2":
        return {
            "ln1": layers.rmsnorm_specs(),
            "mamba": ssm.mamba2_specs(cfg, cfg.ssm),
        }
    p = {
        "ln1": layers.rmsnorm_specs(),
        "attn": attention.attention_specs(cfg),
        "ln2": layers.rmsnorm_specs(),
    }
    if _is_moe(kind):
        p["ffn"] = moe.moe_specs(cfg.moe, impl=cfg.moe_impl)
    else:
        p["ffn"] = mlp.mlp_specs(cfg.activation)
    return p


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _index(tree, i: int):
    """Slice ``i`` of every leaf's leading axis (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):  # a KVCache or MambaCache
        return type(tree)(*(t[i] for t in tree))
    return tree[i]


def _stack_caches(caches: list) -> dict:
    """Per-unit cache dicts -> one dict of caches (``KVCache`` or
    ``MambaCache``) with a leading unit axis."""
    return {k: type(caches[0][k])(*(torch.stack(ts) for ts in zip(*(c[k] for c in caches))))
            for k in caches[0]}


def _init_units(generator, cfg: ModelConfig, dtype) -> dict:
    """The stacked ``(n_units, …)`` unit leaves, allocated once and filled
    unit by unit, leaf by leaf, in the order a list of per-unit trees would
    draw them (meta tensors for ``generator=None``)."""
    n = cfg.resolved_units

    def unit(gen):
        return {f"p{i}": _init_block(gen, kind, cfg, dtype) for i, kind in enumerate(cfg.scan_unit)}

    if generator is None:
        return _map(lambda m: torch.empty((n, *m.shape), dtype=m.dtype, device="meta"),
                    unit(None))
    stacked = None
    for u in range(n):
        rec = layers.DeferredDraws(generator)
        tree = unit(rec)
        if stacked is None:
            stacked = _map(lambda m: torch.empty((n, *m.shape), dtype=m.dtype,
                                                 device=generator.device), tree)
        pairs = list(zip(_leaves(tree), _leaves(_index(stacked, u))))
        dst = {id(leaf): out for leaf, out in pairs}
        for leaf, out in pairs:
            if not leaf.is_meta:  # a constant leaf, made at once
                out.copy_(leaf)
        for leaf, std in rec.draws:
            layers.draw_into(generator, dst[id(leaf)], std)
    return stacked


def init_params(seed_or_generator, cfg: ModelConfig, device=None) -> dict:
    """Random parameters with the reference's tree: truncated normals (std
    as the reference's) and zero norm scales, drawn from a generator on
    ``device`` (default: the CUDA card). An int seeds a new generator there;
    the reference's ``jax.random`` draws cannot be replayed."""
    if isinstance(seed_or_generator, int):
        gen = torch.Generator(device=resolve_device(device)).manual_seed(seed_or_generator)
    else:
        gen = as_generator(seed_or_generator)
    return init_tree(gen, cfg)


def init_tree(generator: torch.Generator | None, cfg: ModelConfig) -> dict:
    """``init_params``'s tree drawn from ``generator``; with ``None``, meta
    tensors of the same shapes and dtypes (what a handover must match)."""
    cfg.validate()
    gen = generator
    dtype = _dtype(cfg.param_dtype)
    params: dict[str, Any] = {}
    if cfg.frontend == "audio":
        params["frontend_proj"] = layers.init_linear(gen, cfg.frontend_dim, cfg.d_model, dtype)
        params["head"] = layers.init_linear(gen, cfg.d_model, cfg.vocab_size, dtype)
    else:
        params["embed"] = layers.init_embed(gen, cfg.vocab_size, cfg.d_model, dtype)
        if cfg.frontend == "vision":
            params["vision_proj"] = layers.init_linear(gen, cfg.frontend_dim, cfg.d_model, dtype)
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.init_linear(gen, cfg.d_model, cfg.vocab_size, dtype,
                                                   std=0.02)
    if cfg.resolved_units:
        params["units"] = _init_units(gen, cfg, dtype)
    if cfg.tail:
        params["tail"] = {f"p{i}": _init_block(gen, kind, cfg, dtype)
                          for i, kind in enumerate(cfg.tail)}
    if "shared_attn" in (*cfg.scan_unit, *cfg.tail):
        params["shared_block"] = _init_block(gen, "attn", cfg, dtype)
    params["ln_f"] = layers.init_rmsnorm(cfg.d_model, dtype, layers.init_device(gen))
    return params


def param_specs(cfg: ModelConfig) -> dict:
    """The PartitionSpec tree of ``init_params``'s tree (the reference's)."""
    cfg.validate()
    specs: dict[str, Any] = {}
    if cfg.frontend == "audio":
        specs["frontend_proj"] = layers.linear_specs(None, FSDP)
        specs["head"] = layers.linear_specs(FSDP, TP)
    else:
        if cfg.embed_table_spec == "dm_data":
            # vocab replicated, d_model FSDP-sharded (the reference's lever)
            specs["embed"] = {"table": P(None, FSDP)}
        else:
            specs["embed"] = layers.embed_specs()
        if cfg.frontend == "vision":
            specs["vision_proj"] = layers.linear_specs(None, FSDP)
        if not cfg.tie_embeddings:
            specs["lm_head"] = layers.linear_specs(FSDP, TP)
    if cfg.resolved_units:
        # stacked along a leading (n_units) axis — prepend None to every spec
        unit = {f"p{i}": _block_specs(kind, cfg) for i, kind in enumerate(cfg.scan_unit)}
        specs["units"] = spec_tree_map(lambda s: P(None, *s), unit)
    if cfg.tail:
        specs["tail"] = {f"p{i}": _block_specs(kind, cfg) for i, kind in enumerate(cfg.tail)}
    if "shared_attn" in (*cfg.scan_unit, *cfg.tail):
        specs["shared_block"] = _block_specs("attn", cfg)
    specs["ln_f"] = layers.rmsnorm_specs()
    return specs


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _ffn(kind, bparams, h, cfg):
    if _is_moe(kind):
        return moe.moe_ffn(bparams["ffn"], h, cfg, cfg.moe)
    return mlp.mlp(bparams["ffn"], h, cfg.activation)


def _apply_block_seq(kind, bparams, x, positions, cfg, shared=None):
    """Train-mode (no cache) application of one block (``shared``: the
    shared_attn kind's weights, ``params["shared_block"]``)."""
    if kind == "shared_attn":
        bparams, kind = shared, "attn"
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        return x + ssm.mamba2_sequence(bparams["mamba"], h, cfg, cfg.ssm)
    x = x + attention.attn_sequence(bparams["attn"], h, positions, cfg, _attn_kind(kind))
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + _ffn(kind, bparams, h, cfg)


def _apply_block_prefill(kind, bparams, x, positions, cfg, cache_len, shared=None):
    """One block over the sequence; also builds its decode cache."""
    if kind == "shared_attn":
        bparams, kind = shared, "attn"
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        out, cache = ssm.mamba2_sequence(bparams["mamba"], h, cfg, cfg.ssm, return_cache=True)
        return x + out, cache
    ak = _attn_kind(kind)
    clen = attention.cache_len_for(ak, cfg, cache_len)
    cache = attention.prefill_kv(bparams["attn"], h, positions, cfg, ak, clen)
    x = x + attention.attn_sequence(bparams["attn"], h, positions, cfg, ak)
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + _ffn(kind, bparams, h, cfg), cache


def _apply_block_decode(kind, bparams, x, pos, cache, cfg, shared=None):
    if kind == "shared_attn":
        bparams, kind = shared, "attn"
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    if kind == "mamba2":
        out, new_cache = ssm.mamba2_decode(bparams["mamba"], h, cache, cfg, cfg.ssm)
        return x + out, new_cache
    out, new_cache = attention.attn_decode(bparams["attn"], h, pos, cache, cfg, _attn_kind(kind))
    x = x + out
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + _ffn(kind, bparams, h, cfg), new_cache


# ---------------------------------------------------------------------------
# Backbone loops (train / prefill / decode)
# ---------------------------------------------------------------------------


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the 2-D
    products (the linears, which ``matmul`` lowers to ``aten.mm``), recompute
    the rest (the attention einsums are batched, ``aten.bmm``)."""
    if op is torch.ops.aten.mm.default:
        return ckpt_util.CheckpointPolicy.MUST_SAVE
    return ckpt_util.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under a non-reentrant checkpoint, with the config's policy."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = partial(ckpt_util.create_selective_checkpoint_contexts,
                                   _save_weight_products)
    return partial(ckpt_util.checkpoint, fn, use_reentrant=False, **kw)


def _backbone_train(params, x, positions, cfg: ModelConfig):
    shared = params.get("shared_block")

    def unit_body(h, unit_p):
        for i, kind in enumerate(cfg.scan_unit):
            h = _apply_block_seq(kind, unit_p[f"p{i}"], h, positions, cfg, shared)
        return h

    if cfg.remat:
        unit_body = _remat(unit_body, cfg)
    for u in range(cfg.resolved_units):
        x = unit_body(x, _index(params["units"], u))
    for i, kind in enumerate(cfg.tail):
        x = _apply_block_seq(kind, params["tail"][f"p{i}"], x, positions, cfg, shared)
    return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def _backbone_prefill(params, x, positions, cfg: ModelConfig, cache_len: int):
    shared = params.get("shared_block")
    caches: dict[str, Any] = {}
    if cfg.resolved_units:
        per_unit = []
        for u in range(cfg.resolved_units):
            unit_p, unit_c = _index(params["units"], u), {}
            for i, kind in enumerate(cfg.scan_unit):
                x, unit_c[f"p{i}"] = _apply_block_prefill(kind, unit_p[f"p{i}"], x, positions,
                                                          cfg, cache_len, shared)
            per_unit.append(unit_c)
        caches["units"] = _stack_caches(per_unit)
    if cfg.tail:
        caches["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            x, caches["tail"][f"p{i}"] = _apply_block_prefill(
                kind, params["tail"][f"p{i}"], x, positions, cfg, cache_len, shared)
    return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def _backbone_decode(params, x, pos, caches, cfg: ModelConfig):
    shared = params.get("shared_block")
    new_caches: dict[str, Any] = {}
    if cfg.resolved_units:
        per_unit = []
        for u in range(cfg.resolved_units):
            unit_p, unit_c, new_c = _index(params["units"], u), _index(caches["units"], u), {}
            for i, kind in enumerate(cfg.scan_unit):
                x, new_c[f"p{i}"] = _apply_block_decode(kind, unit_p[f"p{i}"], x, pos,
                                                        unit_c[f"p{i}"], cfg, shared)
            per_unit.append(new_c)
        new_caches["units"] = _stack_caches(per_unit)
    if cfg.tail:
        new_caches["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            x, new_caches["tail"][f"p{i}"] = _apply_block_decode(
                kind, params["tail"][f"p{i}"], x, pos, caches["tail"][f"p{i}"], cfg, shared)
    return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), new_caches


# ---------------------------------------------------------------------------
# Inputs -> hidden states -> logits
# ---------------------------------------------------------------------------


def _scale_embeddings(x, cfg: ModelConfig):
    """x * sqrt(d_model), the factor rounded to the compute dtype first (the
    reference's ``jnp.asarray(d_model**0.5, cdt)``)."""
    if not cfg.embed_scale:
        return x
    factor = float(torch.tensor(cfg.d_model**0.5, dtype=_compute_dtype(cfg)))
    return x * factor


def _need(batch: dict, key: str, cfg: ModelConfig):
    if key not in batch:
        raise ValueError(f"{cfg.name}: the {cfg.frontend} frontend needs batch[{key!r}] "
                         f"(the batch has {sorted(batch)})")
    return batch[key]


def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (x (B,S,dm), positions) for any modality: (B, S) positions,
    or the vision batch's (3, B, S) M-RoPE grids."""
    cdt = _compute_dtype(cfg)
    if cfg.frontend == "audio":
        x = layers.linear(params["frontend_proj"], _need(batch, "frames", cfg).to(cdt))
        positions = None
    elif cfg.frontend == "vision":
        tok_emb = layers.embed(params["embed"], batch["tokens"], cdt)
        patches = layers.linear(params["vision_proj"], _need(batch, "patches", cfg).to(cdt))
        x = torch.cat([patches, tok_emb], dim=1)  # vision prefix
        positions = _need(batch, "positions", cfg)  # (3, B, S) M-RoPE grids
    else:
        x = layers.embed(params["embed"], batch["tokens"], cdt)
        positions = None
    if positions is None:
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return _scale_embeddings(x, cfg), positions


def _logits(params, x, cfg: ModelConfig):
    ldt = _dtype(cfg.logits_dtype)
    if cfg.frontend == "audio":
        out = layers.linear(params["head"], x).to(ldt)
    elif cfg.tie_embeddings:
        out = layers.unembed(params["embed"], x).to(ldt)
    else:
        out = layers.linear(params["lm_head"], x).to(ldt)
    return layers.softcap(out, cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


class _TokenNLL(torch.autograd.Function):
    """logsumexp(x) - x[target] over the last dim of f32 logits x.

    The forward is the ops the reference writes (``logsumexp``, a gather).
    The backward returns what autograd would make of them,
    ``g * exp(x - logsumexp(x))`` with ``-g`` added at the target, bit for
    bit, but in one (…, V) tensor written in place: autograd's generic
    backward holds three more of that size (the difference, its exp, the
    gather's scattered zeros), 8 GiB each for a (2, 4096, 262,144) batch."""

    @staticmethod
    def forward(ctx, x, idx):
        logz = torch.logsumexp(x, dim=-1)
        ctx.save_for_backward(x, logz, idx)
        return logz - torch.gather(x, -1, idx)[..., 0]

    @staticmethod
    def backward(ctx, g):
        x, logz, idx = ctx.saved_tensors
        grad = (x - logz[..., None]).exp_().mul_(g[..., None])
        return grad.scatter_add_(-1, idx, -g[..., None]), None


def _ce_terms(params, x_slice, targets, mask, cfg):
    """(sum nll, sum mask) for one sequence slice — logits live only here."""
    logits = _logits(params, x_slice, cfg)
    nll = _TokenNLL.apply(logits.float(), targets[..., None].long()) * mask
    return torch.sum(nll), torch.sum(mask)


def forward_train(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Mean loss (0-d f32). LM: next-token CE over ``batch["tokens"]``
    (B, S) (vision: on the text positions only); audio encoder: the
    masked-prediction CE over ``batch["targets"]`` where ``batch["mask"]``."""
    x, positions = _embed_inputs(params, batch, cfg)
    x = _backbone_train(params, x, positions, cfg)
    if cfg.frontend == "audio":
        targets = _need(batch, "targets", cfg)  # (B, S) int32
        mask = _need(batch, "mask", cfg).to(torch.float32)  # (B, S) masked positions
    else:
        tokens = batch["tokens"]
        targets = F.pad(tokens[:, 1:], (0, 1))  # next-token
        mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=x.device),
                     (0, 1))
        if cfg.frontend == "vision":
            x = x[:, x.shape[1] - tokens.shape[1]:]  # only text positions carry LM loss

    S = x.shape[1]
    if cfg.loss_chunk and S % cfg.loss_chunk == 0 and S > cfg.loss_chunk:
        # chunked CE: the (B, c, V) logits are transient per chunk (recomputed
        # in the backward pass), never (B, S, V)
        c = cfg.loss_chunk
        terms = partial(ckpt_util.checkpoint, partial(_ce_terms, params, cfg=cfg),
                        use_reentrant=False)
        nll_sum = mask_sum = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(S // c):
            snll, smask = terms(x[:, j * c:(j + 1) * c], targets[:, j * c:(j + 1) * c],
                                mask[:, j * c:(j + 1) * c])
            nll_sum, mask_sum = nll_sum + snll, mask_sum + smask
    else:
        nll_sum, mask_sum = _ce_terms(params, x, targets, mask, cfg)
    return nll_sum / torch.clamp_min(mask_sum, 1.0)


def forward_prefill(params, batch: dict, cfg: ModelConfig, cache_len: int | None = None):
    """Returns (last-position logits (B, V), caches). Encoder-only: (logits
    (B, S, V), None).

    cache_len: total serving-cache slots (>= seq_len to leave decode room);
    defaults to seq_len.
    """
    x, positions = _embed_inputs(params, batch, cfg)
    if cfg.encoder_only:
        return _logits(params, _backbone_train(params, x, positions, cfg), cfg), None
    cache_len = cache_len or x.shape[1]
    x, caches = _backbone_prefill(params, x, positions, cfg, cache_len)
    logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, caches


def forward_decode(params, batch: dict, caches, cfg: ModelConfig, return_hidden=False):
    """One decode step. batch: {"token": (B,), "pos": (B,)}. Returns (logits
    (B, V), next token (B,) int32, new caches[, final hidden (B, dm)]).

    (For VLM decode, M-RoPE on generated text positions is exactly standard
    RoPE with t=h=w=pos, so the 2D position path is used, as the
    reference's.)"""
    _no_decode(cfg)
    x = layers.embed(params["embed"], batch["token"][:, None], _compute_dtype(cfg))  # (B,1,dm)
    x = _scale_embeddings(x, cfg)
    x, new_caches = _backbone_decode(params, x, batch["pos"], caches, cfg)
    logits = _logits(params, x, cfg)[:, 0]  # (B, V)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if return_hidden:
        return logits, next_tok, new_caches, x[:, 0]
    return logits, next_tok, new_caches


def _no_decode(cfg: ModelConfig) -> None:
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step or caches")


def init_caches(batch: int, seq_len: int, cfg: ModelConfig, device=None) -> dict:
    """Zero caches for decode-from-scratch (serving bootstrap)."""
    _no_decode(cfg)
    dtype, dev = _compute_dtype(cfg), resolve_device(device)

    def cache_for(kind):
        if kind == "mamba2":
            return ssm.init_mamba_cache(batch, cfg, cfg.ssm, dtype, dev)
        ak = _attn_kind(kind if kind != "shared_attn" else "attn")
        clen = attention.cache_len_for(ak, cfg, seq_len)
        return attention.init_kv_cache(batch, clen, cfg, dtype, dev)

    caches: dict[str, Any] = {}
    if cfg.resolved_units:
        caches["units"] = _stack_caches([{f"p{i}": cache_for(k) for i, k in
                                          enumerate(cfg.scan_unit)}] * cfg.resolved_units)
    if cfg.tail:
        caches["tail"] = {f"p{i}": cache_for(k) for i, k in enumerate(cfg.tail)}
    return caches


def cache_specs(cfg: ModelConfig) -> dict:
    """PartitionSpecs for the cache tree (batch over data, heads over model)."""

    def spec_for(kind, stacked: bool):
        lead = (None,) if stacked else ()
        if kind == "mamba2":
            return ssm.MambaCache(
                conv=P(*lead, BATCH, None, TP),
                state=P(*lead, BATCH, TP, None, None),
            )
        # KV caches shard their SEQUENCE dim over "model" by default: head
        # counts (kv=1 MQA) can't split 16 ways, the sequence always can;
        # "heads_model" shards the kv heads instead
        if cfg.cache_spec_mode == "heads_model":
            return attention.KVCache(
                k=P(*lead, BATCH, None, TP, None),
                v=P(*lead, BATCH, None, TP, None),
                k_pos=P(*lead, BATCH, None),
            )
        return attention.KVCache(
            k=P(*lead, BATCH, TP, None, None),
            v=P(*lead, BATCH, TP, None, None),
            k_pos=P(*lead, BATCH, TP),
        )

    specs: dict[str, Any] = {}
    if cfg.resolved_units:
        specs["units"] = {f"p{i}": spec_for(k, True) for i, k in enumerate(cfg.scan_unit)}
    if cfg.tail:
        specs["tail"] = {f"p{i}": spec_for(k, False) for i, k in enumerate(cfg.tail)}
    return specs
