"""Attention: GQA/MQA, qk-norm, RoPE/M-RoPE/NoPE, full/sliding-window/chunked.

Counterpart of ``repro.models.attention``, op for op in plain PyTorch (the
reference writes attention in jnp, not Pallas, so there is no kernel here):

  * ``attn_sequence`` (prefill): the reference's blockwise online-softmax
    attention — a loop over query blocks, an inner loop over KV blocks with
    the (m, l, o) accumulator in f32, the triangular block skip for causal
    full attention — and, for local and chunked kinds at long S, its
    static KV window per query block;
  * ``attn_decode`` (serving): one new token against a ring-buffer KV cache
    with absolute positions (``k_pos``), so full/local/chunked masking is one
    position predicate over the cached slots.

Every mask is the reference's: padded keys carry ``k_pos = -1``, the window
and chunk predicates, the ``NEG_INF`` floor and the ``max(l, 1e-30)``
divisor. Query-key and probability-value products take f32 results from
compute-dtype operands as the reference's ``preferred_element_type=float32``
does (both operands upcast, as ``layers.f32_product``); the probabilities are rounded to the value
dtype first, as there. GQA head h reads kv head h // G: queries are viewed
as (Hkv, G), never repeated.

Two behaviours of the reference are kept or bounded on purpose (ROADMAP.md
Queue C item 2): ``prefill_kv`` stores the last ``cache_len`` keys at slots
0..C-1 while ``attn_decode`` writes position p at slot p % C, so past a
full window whose length is not a multiple of the window, the first decode
step overwrites a key still inside it — the port does the same. And where
the padded key length is not a multiple of ``blk_kv`` the reference's
blocked reshape raises; the port pads the keys to the next block with
``k_pos = -1`` (masked, as the reference masks its padded queries), which
leaves every shape the reference runs unchanged.

KV caches are rotated at write time (keys stored post-RoPE). Every function
here is functional: ``attn_decode`` returns a new cache and leaves the one
it was given as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers

NEG_INF = -1e30  # repro: allow[RPR003] additive attention-mask logit floor, not a wl1 distance fill (softmax needs finite)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_attention(generator, cfg: ModelConfig, dtype) -> dict:
    dm, H, Hkv, D = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": layers.init_linear(generator, dm, H * D, dtype),
        "wk": layers.init_linear(generator, dm, Hkv * D, dtype),
        "wv": layers.init_linear(generator, dm, Hkv * D, dtype),
        "wo": layers.init_linear(generator, H * D, dm, dtype, std=(H * D) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rmsnorm(D, dtype, layers.init_device(generator))
        p["k_norm"] = layers.init_rmsnorm(D, dtype, layers.init_device(generator))
    return p


class KVCache(NamedTuple):
    """Ring-buffer KV cache for one attention layer."""

    k: torch.Tensor  # (B, C, Hkv, D) — rotated keys
    v: torch.Tensor  # (B, C, Hkv, D)
    k_pos: torch.Tensor  # (B, C) int32 absolute positions (-1 = empty)

    @property
    def cache_len(self) -> int:
        return self.k.shape[1]


def init_kv_cache(batch: int, cache_len: int, cfg: ModelConfig, dtype, device=None) -> KVCache:
    Hkv, D = cfg.n_kv_heads, cfg.head_dim
    return KVCache(
        k=torch.zeros((batch, cache_len, Hkv, D), dtype=dtype, device=device),
        v=torch.zeros((batch, cache_len, Hkv, D), dtype=dtype, device=device),
        k_pos=torch.full((batch, cache_len), -1, dtype=torch.int32, device=device),
    )


def cache_len_for(kind: str, cfg: ModelConfig, seq_len: int) -> int:
    if kind == "local":
        return min(cfg.window, seq_len)
    if kind == "chunked":
        return min(cfg.chunk_size, seq_len)
    return seq_len  # full / global / global_nope / shared_attn


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------


def _qkv(params, x, cfg: ModelConfig, positions, kind: str):
    """Project + norm + rotate. x (B, S, dm) -> q (B,S,H,D), k/v (B,S,Hkv,D)."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = layers.linear(params["wq"], x).reshape(B, S, H, D)
    k = layers.linear(params["wk"], x).reshape(B, S, Hkv, D)
    v = layers.linear(params["wv"], x).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = layers.rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = layers.rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if kind != "global_nope":
        theta = cfg.rope_theta
        if kind == "local" and cfg.rope_local_theta is not None:
            theta = cfg.rope_local_theta
        if cfg.pos == "mrope" and positions.ndim == 3:
            q = layers.apply_mrope(q, positions, theta, cfg.mrope_sections)
            k = layers.apply_mrope(k, positions, theta, cfg.mrope_sections)
        else:
            pos2d = positions if positions.ndim == 2 else positions[0]
            q = layers.apply_rope(q, pos2d, theta)
            k = layers.apply_rope(k, pos2d, theta)
    return q, k, v


# ---------------------------------------------------------------------------
# Blockwise (flash-style) sequence attention
# ---------------------------------------------------------------------------


def _block_mask(kind: str, causal: bool, q_pos, k_pos, window: int, chunk: int):
    """(..., q, k) boolean mask from absolute positions."""
    valid = k_pos[..., None, :] >= 0
    if causal:
        valid = valid & (k_pos[..., None, :] <= q_pos[..., :, None])
    if kind == "local":
        valid = valid & (k_pos[..., None, :] > q_pos[..., :, None] - window)
    elif kind == "chunked":
        q_chunk = torch.div(q_pos, chunk, rounding_mode="floor")
        k_chunk = torch.div(k_pos, chunk, rounding_mode="floor")
        valid = valid & (k_chunk[..., None, :] == q_chunk[..., :, None])
    return valid


def _blocks(pos, n: int, blk: int):
    """Positions (B, S) or (S,) as (B, n, blk) or (n, blk) blocks."""
    return pos.reshape(pos.shape[0], n, blk) if pos.ndim == 2 else pos.reshape(n, blk)


def _sdpa_blocked(q, k, v, q_pos, k_pos, cfg: ModelConfig, kind: str, blk_q: int,
                  blk_kv: int, tri_ok: bool = False):
    """Online-softmax attention. q (B,Sq,H,D); k/v (B,Sk,Hkv,D); pos int tensors.

    Returns (B, Sq, H, D). Sq % blk_q == 0 and Sk % blk_kv == 0 (the caller pads).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D**-0.5
    nq, nk = Sq // blk_q, Sk // blk_kv

    qb = q.reshape(B, nq, blk_q, Hkv, G, D)
    qpb = _blocks(q_pos, nq, blk_q)
    kb = k.reshape(B, nk, blk_kv, Hkv, D)
    vb = v.reshape(B, nk, blk_kv, Hkv, D)
    kpb = _blocks(k_pos, nk, blk_kv)

    # triangular skip: for causal FULL attention a KV block strictly above the
    # diagonal contributes nothing, and is not computed (the reference's
    # lax.cond; here a Python test on block indices)
    tri_skip = cfg.causal and (
        kind in ("attn", "global", "global_nope", "shared_attn") or tri_ok
    )

    outs = []
    for qi in range(nq):
        q_i = qb[:, qi]  # (B, blk_q, Hkv, G, D)
        qp_i = qpb[..., qi, :]
        m = torch.full((B, Hkv, G, blk_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G, blk_q), dtype=torch.float32, device=q.device)
        o = torch.zeros((B, Hkv, G, blk_q, D), dtype=torch.float32, device=q.device)
        for ki in range(nk):
            if tri_skip and not ki * blk_kv <= (qi + 1) * blk_q - 1:
                continue
            k_j, v_j, kp_j = kb[:, ki], vb[:, ki], kpb[..., ki, :]
            # logits (B, Hkv, G, blk_q, blk_kv)
            logits = torch.einsum("bqhgd,bkhd->bhgqk", q_i.float(), k_j.float()) * scale
            mask = _block_mask(kind, cfg.causal, qp_i, kp_j, cfg.window, cfg.chunk_size)
            if mask.ndim == 2:
                mask = mask[None]
            logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_j.dtype).float(), v_j.float())
            o = o * corr[..., None] + pv
            m = m_new
        out = o / torch.clamp_min(l[..., None], 1e-30)  # (B, Hkv, G, blk_q, D)
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))  # (B, blk_q, Hkv, G, D)
    return torch.stack(outs, dim=1).reshape(B, Sq, H, D)


def _sdpa_windowed(q, k, v, q_pos, k_pos, cfg: ModelConfig, kind: str, blk_q: int):
    """Local/chunked attention: each query block sees a static KV window.

    Window span W + blk_q where W = window (local) or chunk_size (chunked) —
    linear-in-S FLOPs, the sub-quadratic path used by long-context archs.
    """
    B, Sq, H, D = q.shape
    W = cfg.window if kind == "local" else cfg.chunk_size
    W = min(W, k.shape[1])
    Hkv = k.shape[2]
    G = H // Hkv
    scale = D**-0.5
    nq = Sq // blk_q
    span = W + blk_q

    qb = q.reshape(B, nq, blk_q, Hkv, G, D)
    qpb = _blocks(q_pos, nq, blk_q)
    outs = []
    for qi in range(nq):
        q_i = qb[:, qi]
        qp_i = qpb[..., qi, :]
        start = min(max(qi * blk_q - W, 0), k.shape[1] - span)
        k_w = k[:, start:start + span]
        v_w = v[:, start:start + span]
        kp_w = k_pos[..., start:start + span]
        logits = torch.einsum("bqhgd,bkhd->bhgqk", q_i.float(), k_w.float()) * scale
        mask = _block_mask(kind, cfg.causal, qp_i, kp_w, cfg.window, cfg.chunk_size)
        if mask.ndim == 2:
            mask = mask[None]
        logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
        m = torch.amax(logits, dim=-1, keepdim=True)
        p = torch.exp(logits - m)
        l = torch.sum(p, dim=-1, keepdim=True)
        probs = (p / torch.clamp_min(l, 1e-30)).to(v_w.dtype)
        out = torch.einsum("bhgqk,bkhd->bhgqd", probs.float(), v_w.float())
        outs.append(torch.movedim(out, 3, 1).to(q.dtype))  # (B, blk_q, Hkv, G, D)
    return torch.stack(outs, dim=1).reshape(B, Sq, H, D)


def _pad_seq(t, pad: int, value=0):
    """Pad dim 1 of t ((B, S) or (B, S, H, D)) at the end by ``pad``."""
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad), value=value)


def attn_sequence(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    blk_q: int | None = None,
    blk_kv: int | None = None,
) -> torch.Tensor:
    """Full-sequence attention (prefill). x (B, S, dm) -> (B, S, dm)."""
    blk_q = blk_q or cfg.attn_blk_q
    blk_kv = blk_kv or cfg.attn_blk_kv
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg, positions, kind)
    pos2d = positions if positions.ndim == 2 else positions[0]

    blk_q = min(blk_q, S)
    blk_kv = min(blk_kv, S)
    pad_q = -S % blk_q
    if pad_q:  # pad queries/keys to block multiple; padded k_pos = -1 masks them
        q, k, v = (_pad_seq(t, pad_q) for t in (q, k, v))
        pos2d = _pad_seq(pos2d, pad_q, value=-1)

    if kind in ("local", "chunked") and k.shape[1] > (
        (cfg.window if kind == "local" else cfg.chunk_size) + blk_q
    ):
        out = _sdpa_windowed(q, k, v, pos2d, pos2d, cfg, kind, blk_q)
    else:
        # chunked at S <= chunk_size degenerates to plain causal: the
        # triangular block skip applies
        tri_ok = kind == "chunked" and S <= cfg.chunk_size
        k_pos = pos2d
        pad_k = -k.shape[1] % blk_kv
        if pad_k:  # where the reference's reshape raises: masked key padding
            k, v = _pad_seq(k, pad_k), _pad_seq(v, pad_k)
            k_pos = _pad_seq(pos2d, pad_k, value=-1)
        out = _sdpa_blocked(q, k, v, pos2d, k_pos, cfg, kind, blk_q, blk_kv, tri_ok)
    if pad_q:
        out = out[:, :S]
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim)
    return layers.linear(params["wo"], out)


def prefill_kv(
    params: dict,
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    kind: str,
    cache_len: int,
) -> KVCache:
    """Build the layer's KV cache from a prefilled sequence (last cache_len slots)."""
    B, S, _ = x.shape
    _, k, v = _qkv(params, x, cfg, positions, kind)
    pos2d = positions if positions.ndim == 2 else positions[0]
    if S >= cache_len:
        k = k[:, S - cache_len:]
        v = v[:, S - cache_len:]
        kp = pos2d[:, S - cache_len:]
    else:
        pad = cache_len - S
        k, v = _pad_seq(k, pad), _pad_seq(v, pad)
        kp = _pad_seq(pos2d, pad, value=-1)
    return KVCache(k=k, v=v, k_pos=kp.to(torch.int32))


def attn_decode(
    params: dict,
    x: torch.Tensor,
    pos: torch.Tensor,
    cache: KVCache,
    cfg: ModelConfig,
    kind: str,
) -> tuple[torch.Tensor, KVCache]:
    """One-token decode. x (B, 1, dm); pos (B,) absolute position of the new token."""
    B = x.shape[0]
    q, k_new, v_new = _qkv(params, x, cfg, positions=pos[:, None], kind=kind)
    # ring-buffer write into copies (the caller's cache stays as it was)
    slot = torch.remainder(pos, cache.cache_len).long()  # (B,)
    bidx = torch.arange(B, device=x.device)
    k, v, k_pos = cache.k.clone(), cache.v.clone(), cache.k_pos.clone()
    k[bidx, slot] = k_new[:, 0].to(k.dtype)
    v[bidx, slot] = v_new[:, 0].to(v.dtype)
    k_pos[bidx, slot] = pos.to(torch.int32)
    new_cache = KVCache(k=k, v=v, k_pos=k_pos)

    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(), k.float()) * (D**-0.5)
    mask = _block_mask(kind, True, pos[:, None], k_pos, cfg.window, cfg.chunk_size)[:, 0, :]
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v.dtype).float(), v.float())
    out = out.reshape(B, 1, H * D).to(x.dtype)
    out = layers.linear(params["wo"], out)
    return out, new_cache
