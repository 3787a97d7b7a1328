"""Model assembly: layer patterns of scan units and a tail, three run modes.

Counterpart of ``repro.models.model`` for the dense architectures. Layer
patterns: ``cfg.scan_unit`` is a tuple of layer kinds repeated ``n_units``
times — its parameters stacked along a leading (n_units) axis, as the
reference's ``vmap``'d init lays them out — followed by an explicit
``tail``. The reference runs the units under ``lax.scan``; the port runs
them in a Python loop over the stacked parameters (each unit's slice is a
view, not a copy) and stacks the units' caches again at the end.

Ported kinds: ``attn``, ``local``, ``global``, ``chunked`` and
``global_nope``, each an attention block plus a dense MLP. ``mamba2``,
``shared_attn``, the ``_moe`` suffix, the audio and vision frontends and
encoder-only models raise :func:`repro_torch.not_ported` (ROADMAP.md Queue A
item 14c) before any work; ``param_specs`` and ``cache_specs``
(PartitionSpec trees) wait for item 14d.

Run modes:
  forward_train   — full-sequence forward + next-token CE loss
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
one to one.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt_util

from repro_torch import not_ported
from repro_torch.api.index import as_generator, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, layers, mlp

ATTN_KINDS = ("attn", "local", "global", "chunked", "global_nope")
NOT_PORTED_ITEM = "Queue A item 14c"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``not_ported``, naming every part of ``cfg`` this package does
    not run (MoE layers, other layer kinds, a frontend, encoder-only)."""
    kinds = dict.fromkeys((*cfg.scan_unit, *cfg.tail))
    parts = [f"MoE layers ({k!r})" for k in kinds if k.endswith("_moe")]
    parts += [f"layer kind {k!r}" for k in kinds if not k.endswith("_moe")
              and k not in ATTN_KINDS]
    if cfg.frontend is not None:
        parts.append(f"the {cfg.frontend} frontend")
    if cfg.encoder_only:
        parts.append("encoder-only models")
    if parts:
        raise not_ported(f"{cfg.name}: {', '.join(parts)}", NOT_PORTED_ITEM)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_block(generator, kind: str, cfg: ModelConfig, dtype) -> dict:
    """Params for one attention layer of the given kind."""
    dev = layers.init_device(generator)
    return {
        "ln1": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        "attn": attention.init_attention(generator, cfg, dtype),
        "ln2": layers.init_rmsnorm(cfg.d_model, dtype, dev),
        "ffn": mlp.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.activation, dtype),
    }


def _stack(trees: list) -> Any:
    """Stack same-structure dicts of tensors along a new leading axis."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, i: int):
    """Slice ``i`` of every leaf's leading axis (views)."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, attention.KVCache):
        return attention.KVCache(*(t[i] for t in tree))
    return tree[i]


def _stack_caches(caches: list) -> dict:
    """Per-unit cache dicts -> one dict of KVCaches with a leading unit axis."""
    return {k: attention.KVCache(*(torch.stack(ts) for ts in zip(*(c[k] for c in caches))))
            for k in caches[0]}


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
    check_ported(cfg)
    gen = generator
    dtype = _dtype(cfg.param_dtype)
    params: dict[str, Any] = {
        "embed": layers.init_embed(gen, cfg.vocab_size, cfg.d_model, dtype)}
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.init_linear(gen, cfg.d_model, cfg.vocab_size, dtype,
                                               std=0.02)
    if cfg.resolved_units:
        params["units"] = _stack([
            {f"p{i}": _init_block(gen, kind, cfg, dtype) for i, kind in enumerate(cfg.scan_unit)}
            for _ in range(cfg.resolved_units)])
    if cfg.tail:
        params["tail"] = {f"p{i}": _init_block(gen, kind, cfg, dtype)
                          for i, kind in enumerate(cfg.tail)}
    params["ln_f"] = layers.init_rmsnorm(cfg.d_model, dtype, layers.init_device(gen))
    return params


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _apply_block_seq(kind, bparams, x, positions, cfg):
    """Train-mode (no cache) application of one block."""
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    x = x + attention.attn_sequence(bparams["attn"], h, positions, cfg, kind)
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + mlp.mlp(bparams["ffn"], h, cfg.activation)


def _apply_block_prefill(kind, bparams, x, positions, cfg, cache_len):
    """One block over the sequence; also builds its decode cache."""
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    clen = attention.cache_len_for(kind, cfg, cache_len)
    cache = attention.prefill_kv(bparams["attn"], h, positions, cfg, kind, clen)
    x = x + attention.attn_sequence(bparams["attn"], h, positions, cfg, kind)
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + mlp.mlp(bparams["ffn"], h, cfg.activation), cache


def _apply_block_decode(kind, bparams, x, pos, cache, cfg):
    h = layers.rmsnorm(bparams["ln1"], x, cfg.norm_eps)
    out, new_cache = attention.attn_decode(bparams["attn"], h, pos, cache, cfg, kind)
    x = x + out
    h = layers.rmsnorm(bparams["ln2"], x, cfg.norm_eps)
    return x + mlp.mlp(bparams["ffn"], h, cfg.activation), new_cache


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
    def unit_body(h, unit_p):
        for i, kind in enumerate(cfg.scan_unit):
            h = _apply_block_seq(kind, unit_p[f"p{i}"], h, positions, cfg)
        return h

    if cfg.remat:
        unit_body = _remat(unit_body, cfg)
    for u in range(cfg.resolved_units):
        x = unit_body(x, _index(params["units"], u))
    for i, kind in enumerate(cfg.tail):
        x = _apply_block_seq(kind, params["tail"][f"p{i}"], x, positions, cfg)
    return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps)


def _backbone_prefill(params, x, positions, cfg: ModelConfig, cache_len: int):
    caches: dict[str, Any] = {}
    if cfg.resolved_units:
        per_unit = []
        for u in range(cfg.resolved_units):
            unit_p, unit_c = _index(params["units"], u), {}
            for i, kind in enumerate(cfg.scan_unit):
                x, unit_c[f"p{i}"] = _apply_block_prefill(kind, unit_p[f"p{i}"], x, positions,
                                                          cfg, cache_len)
            per_unit.append(unit_c)
        caches["units"] = _stack_caches(per_unit)
    if cfg.tail:
        caches["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            x, caches["tail"][f"p{i}"] = _apply_block_prefill(
                kind, params["tail"][f"p{i}"], x, positions, cfg, cache_len)
    return layers.rmsnorm(params["ln_f"], x, cfg.norm_eps), caches


def _backbone_decode(params, x, pos, caches, cfg: ModelConfig):
    new_caches: dict[str, Any] = {}
    if cfg.resolved_units:
        per_unit = []
        for u in range(cfg.resolved_units):
            unit_p, unit_c, new_c = _index(params["units"], u), _index(caches["units"], u), {}
            for i, kind in enumerate(cfg.scan_unit):
                x, new_c[f"p{i}"] = _apply_block_decode(kind, unit_p[f"p{i}"], x, pos,
                                                        unit_c[f"p{i}"], cfg)
            per_unit.append(new_c)
        new_caches["units"] = _stack_caches(per_unit)
    if cfg.tail:
        new_caches["tail"] = {}
        for i, kind in enumerate(cfg.tail):
            x, new_caches["tail"][f"p{i}"] = _apply_block_decode(
                kind, params["tail"][f"p{i}"], x, pos, caches["tail"][f"p{i}"], cfg)
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


def _embed_inputs(params, batch: dict, cfg: ModelConfig):
    """Returns (x (B,S,dm), positions (B,S)) for token inputs."""
    x = layers.embed(params["embed"], batch["tokens"], _compute_dtype(cfg))
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    return _scale_embeddings(x, cfg), positions


def _logits(params, x, cfg: ModelConfig):
    ldt = _dtype(cfg.logits_dtype)
    if cfg.tie_embeddings:
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
    """Mean next-token CE loss (0-d f32) over ``batch["tokens"]`` (B, S)."""
    check_ported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x = _backbone_train(params, x, positions, cfg)
    tokens = batch["tokens"]
    targets = F.pad(tokens[:, 1:], (0, 1))  # next-token
    mask = F.pad(torch.ones(tokens[:, 1:].shape, dtype=torch.float32, device=x.device), (0, 1))

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
    """Returns (last-position logits (B, V), caches).

    cache_len: total serving-cache slots (>= seq_len to leave decode room);
    defaults to seq_len.
    """
    check_ported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    cache_len = cache_len or x.shape[1]
    x, caches = _backbone_prefill(params, x, positions, cfg, cache_len)
    logits = _logits(params, x[:, -1:, :], cfg)[:, 0]
    return logits, caches


def forward_decode(params, batch: dict, caches, cfg: ModelConfig, return_hidden=False):
    """One decode step. batch: {"token": (B,), "pos": (B,)}. Returns (logits
    (B, V), next token (B,) int32, new caches[, final hidden (B, dm)])."""
    check_ported(cfg)
    x = layers.embed(params["embed"], batch["token"][:, None], _compute_dtype(cfg))  # (B,1,dm)
    x = _scale_embeddings(x, cfg)
    x, new_caches = _backbone_decode(params, x, batch["pos"], caches, cfg)
    logits = _logits(params, x, cfg)[:, 0]  # (B, V)
    next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    if return_hidden:
        return logits, next_tok, new_caches, x[:, 0]
    return logits, next_tok, new_caches


def init_caches(batch: int, seq_len: int, cfg: ModelConfig, device=None) -> dict:
    """Zero caches for decode-from-scratch (serving bootstrap)."""
    check_ported(cfg)
    dtype, dev = _compute_dtype(cfg), resolve_device(device)

    def cache_for(kind):
        clen = attention.cache_len_for(kind, cfg, seq_len)
        return attention.init_kv_cache(batch, clen, cfg, dtype, dev)

    caches: dict[str, Any] = {}
    if cfg.resolved_units:
        caches["units"] = _stack_caches([{f"p{i}": cache_for(k) for i, k in
                                          enumerate(cfg.scan_unit)}] * cfg.resolved_units)
    if cfg.tail:
        caches["tail"] = {f"p{i}": cache_for(k) for i, k in enumerate(cfg.tail)}
    return caches
