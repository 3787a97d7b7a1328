"""Mamba2 (SSD — state-space duality) block: chunked train/prefill scan +
constant-memory single-step decode.

Counterpart of ``repro.models.ssm``, op for op in plain PyTorch (the
reference writes the scan in jnp, not Pallas). Dao & Gu (arXiv:2405.21060):
per-head scalar decay A, grouped B/C (n_groups), depthwise causal conv on
(x, B, C), softplus dt with bias, gated RMSNorm before the out-projection.

Chunked algorithm (chunk = Q):
  intra:  Y_c = (C_c B_c^T ⊙ L_c) (dt_c ⊙ x_c)        — quadratic within chunk
  states: S_c = Σ_j exp(cum_end - cum_j) dt_j B_j x_j^T — one state per chunk
  inter:  R_c = exp(Σ dA_c) R_{c-1} + S_c over the chunks (the reference's
          ``lax.scan``; here a Python loop over the nc chunks)
          Y_c += exp(cum) C_c R_{c-1}

All recurrence math is float32, the projections and the conv in the model's
compute dtype; the exponents are clipped at -60 as the reference's. The
three-operand einsum of the inter-chunk output contracts in another order
than XLA's, so f32 outputs agree to rounding, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.models import layers
from repro_torch.models.sharding import FSDP, TP, P

CLIP = -60.0  # exponent floor of every decay, as the reference's


def _dims(cfg: ModelConfig, scfg: SSMConfig):
    d_inner = scfg.expand * cfg.d_model
    nh = d_inner // scfg.head_dim
    conv_dim = d_inner + 2 * scfg.n_groups * scfg.d_state
    return d_inner, nh, conv_dim


def init_mamba2(generator, cfg: ModelConfig, scfg: SSMConfig, dtype) -> dict:
    d_inner, nh, conv_dim = _dims(cfg, scfg)
    d_in_proj = 2 * d_inner + 2 * scfg.n_groups * scfg.d_state + nh
    dev = layers.init_device(generator)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "in_proj": layers.init_linear(generator, cfg.d_model, d_in_proj, dtype),
        "conv_w": layers.truncated_normal_init(generator, (scfg.d_conv, conv_dim), 0.2, dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 1e-2, **f32))),
        "norm": layers.init_rmsnorm(d_inner, dtype, dev),
        "out_proj": layers.init_linear(generator, d_inner, cfg.d_model, dtype,
                                       std=d_inner**-0.5),
    }


def mamba2_specs(cfg: ModelConfig, scfg: SSMConfig) -> dict:
    return {
        "in_proj": layers.linear_specs(FSDP, TP),
        "conv_w": P(None, TP),
        "conv_b": P(TP),
        "A_log": P(None),
        "D": P(None),
        "dt_bias": P(None),
        "norm": layers.rmsnorm_specs(),
        "out_proj": layers.linear_specs(TP, FSDP),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv - 1, conv_dim) last conv inputs
    state: torch.Tensor  # (B, nh, head_dim, d_state) float32 SSM state


def init_mamba_cache(batch: int, cfg: ModelConfig, scfg: SSMConfig, dtype,
                     device=None) -> MambaCache:
    _, nh, conv_dim = _dims(cfg, scfg)
    return MambaCache(
        conv=torch.zeros((batch, scfg.d_conv - 1, conv_dim), dtype=dtype, device=device),
        state=torch.zeros((batch, nh, scfg.head_dim, scfg.d_state), dtype=torch.float32,
                          device=device),
    )


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-over."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(proj, cfg: ModelConfig, scfg: SSMConfig):
    d_inner, nh, _ = _dims(cfg, scfg)
    gs = scfg.n_groups * scfg.d_state
    z, xBC, dt = torch.split(proj, [d_inner, d_inner + 2 * gs, nh], dim=-1)
    return z, xBC, dt  # dt (…, nh)


def _conv_sequence(xBC, params, scfg: SSMConfig, init_conv=None):
    """Depthwise causal conv1d along seq. xBC (B, S, conv_dim) -> (silu(conv),
    the last d_conv - 1 inputs of the padded sequence)."""
    B, S, Cd = xBC.shape
    K = scfg.d_conv
    if init_conv is None:
        init_conv = torch.zeros((B, K - 1, Cd), dtype=xBC.dtype, device=xBC.device)
    padded = torch.cat([init_conv, xBC], dim=1)  # (B, S+K-1, Cd)
    w = params["conv_w"].to(xBC.dtype)  # (K, Cd)
    out = torch.zeros_like(xBC)
    for i in range(K):  # K is tiny (4): unrolled taps
        out = out + padded[:, i:i + S, :] * w[i][None, None, :]
    out = out + params["conv_b"].to(xBC.dtype)[None, None, :]
    return F.silu(out), padded[:, -(K - 1):, :] if K > 1 else init_conv


def mamba2_sequence(params: dict, u: torch.Tensor, cfg: ModelConfig, scfg: SSMConfig,
                    return_cache: bool = False):
    """u (B, S, dm) -> (B, S, dm) [, MambaCache]. Chunked SSD scan."""
    B, S, _ = u.shape
    d_inner, nh, _ = _dims(cfg, scfg)
    hd, ds, ng = scfg.head_dim, scfg.d_state, scfg.n_groups
    Q = min(scfg.chunk, S)
    pad = -S % Q
    nc = (S + pad) // Q
    f32 = torch.float32

    proj = layers.linear(params["in_proj"], u)
    z, xBC, dt = _split_proj(proj, cfg, scfg)
    xBC, conv_tail = _conv_sequence(xBC, params, scfg)
    x, Bm, Cm = torch.split(xBC, [d_inner, ng * ds, ng * ds], dim=-1)

    # float32 recurrence land
    x = x.reshape(B, S, nh, hd).to(f32)
    Bm = Bm.reshape(B, S, ng, ds).to(f32)
    Cm = Cm.reshape(B, S, ng, ds).to(f32)
    dt = _softplus(dt.to(f32) + params["dt_bias"][None, None, :])  # (B, S, nh)
    A = -torch.exp(params["A_log"])  # (nh,)
    dA = dt * A[None, None, :]  # (B, S, nh) negative

    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt, dA = (F.pad(t, (0, 0, 0, pad)) for t in (dt, dA))

    Sp = S + pad
    xc = x.reshape(B, nc, Q, nh, hd)
    Bc = Bm.reshape(B, nc, Q, ng, ds)
    Cc = Cm.reshape(B, nc, Q, ng, ds)
    dtc = dt.reshape(B, nc, Q, nh)
    dAc = dA.reshape(B, nc, Q, nh)
    cum = torch.cumsum(dAc, dim=2)  # (B, nc, Q, nh) inclusive
    total = cum[:, :, -1, :]  # (B, nc, nh)

    # intra-chunk: heads share group B/C (ng == 1 assumed for head broadcast)
    CB = torch.einsum("bcqgs,bckgs->bcqk", Cc, Bc)  # (B, nc, Q, Q) group-summed
    # L[b,c,i,j,h] = exp(cum_i - cum_j) for i >= j
    Lmat = torch.exp(torch.clamp(cum[:, :, :, None, :] - cum[:, :, None, :, :], CLIP, 0.0))
    tri = torch.tril(torch.ones((Q, Q), dtype=f32, device=u.device))
    W = CB[..., None] * Lmat * tri[None, None, :, :, None]  # (B, nc, Q, Q, nh)
    dx = dtc[..., None] * xc  # (B, nc, Q, nh, hd)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", W, dx)

    # chunk states: S_c[h,p,s] = sum_j exp(total - cum_j) dx_j[h,p] B_j[s]
    decay_state = torch.exp(torch.clamp(total[:, :, None, :] - cum, min=CLIP))  # (B,nc,Q,nh)
    Sc = torch.einsum("bcqh,bcqhp,bcqgs->bchps", decay_state, dx, Bc)  # (B,nc,nh,hd,ds)

    # inter-chunk recurrence: the state entering each chunk
    R = torch.zeros((B, nh, hd, ds), dtype=f32, device=u.device)
    R_prevs = []
    for c in range(nc):
        R_prevs.append(R)
        R = R * torch.exp(torch.clamp(total[:, c], CLIP, 0.0))[:, :, None, None] + Sc[:, c]
    R_prev = torch.stack(R_prevs, dim=1)  # (B, nc, nh, hd, ds)

    decay_in = torch.exp(torch.clamp(cum, CLIP, 0.0))  # (B, nc, Q, nh)
    y_inter = torch.einsum("bcqgs,bchps,bcqh->bcqhp", Cc, R_prev, decay_in)

    y = (y_intra + y_inter).reshape(B, Sp, nh, hd)[:, :S]
    y = y + params["D"][None, None, :, None] * x.reshape(B, Sp, nh, hd)[:, :S]
    y = y.reshape(B, S, d_inner)

    # gated RMSNorm + out projection
    y = y * F.silu(z.to(f32))
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps).to(u.dtype)
    out = layers.linear(params["out_proj"], y)
    if return_cache:
        return out, MambaCache(conv=conv_tail.to(u.dtype), state=R)
    return out


def mamba2_decode(params: dict, u: torch.Tensor, cache: MambaCache, cfg: ModelConfig,
                  scfg: SSMConfig):
    """One-token decode. u (B, 1, dm) -> (B, 1, dm), new cache. O(1) in context;
    the cache it was given is left as it was."""
    B = u.shape[0]
    d_inner, nh, _ = _dims(cfg, scfg)
    hd, ds, ng = scfg.head_dim, scfg.d_state, scfg.n_groups
    f32 = torch.float32

    proj = layers.linear(params["in_proj"], u)[:, 0]  # (B, d_in_proj)
    z, xBC, dt = _split_proj(proj, cfg, scfg)

    # conv ring buffer
    window = torch.cat([cache.conv, xBC[:, None, :]], dim=1)  # (B, K, conv_dim)
    w = params["conv_w"].to(xBC.dtype)
    xBC = torch.einsum("bkc,kc->bc", window, w) + params["conv_b"].to(xBC.dtype)
    xBC = F.silu(xBC)
    new_conv = window[:, 1:, :]

    x, Bm, Cm = torch.split(xBC, [d_inner, ng * ds, ng * ds], dim=-1)
    x = x.reshape(B, nh, hd).to(f32)
    Bm = Bm.reshape(B, ng, ds).to(f32)[:, 0]  # ng == 1
    Cm = Cm.reshape(B, ng, ds).to(f32)[:, 0]
    dt = _softplus(dt.to(f32) + params["dt_bias"][None, :])  # (B, nh)
    A = -torch.exp(params["A_log"])
    decay = torch.exp(dt * A[None, :])  # (B, nh)

    dx = dt[..., None] * x  # (B, nh, hd)
    state = cache.state * decay[:, :, None, None] + torch.einsum("bhp,bs->bhps", dx, Bm)
    y = torch.einsum("bhps,bs->bhp", state, Cm) + params["D"][None, :, None] * x
    y = y.reshape(B, d_inner)
    y = y * F.silu(z.to(f32))
    y = layers.rmsnorm(params["norm"], y, cfg.norm_eps).to(u.dtype)
    out = layers.linear(params["out_proj"], y)[:, None, :]
    return out, MambaCache(conv=new_conv, state=state)
