"""AdamW from scratch: dtype-configurable moments, warmup+cosine schedule,
global-norm clipping, and gradient compression (bf16 cast / int8 + error
feedback).

Counterpart of ``repro.optim.adamw``, op for op. Moments are stored in
``optimizer_dtype`` (bf16 halves optimizer memory) but all update math runs
in f32. Trees are nested dicts of tensors with the parameters' structure;
every function walks them in the reference's leaf order (sorted keys), so
sums over leaves add in the same order.

Everything stays on the parameters' device: ``step`` is a 0-d int32
tensor, and the learning rate and the bias corrections are 0-d f32 tensors
computed from it there, as the reference computes them (no host sync, no
Python doubles). Every function is functional — it returns new tensors and
writes none it was given — so a caller may keep the old state (a
checkpoint being written) while the new one is made. The update runs under
``torch.no_grad()``: the new parameters carry no autograd history.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from repro_torch import not_ported
from repro_torch.configs.base import TrainConfig


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32
    m: dict  # first moments (params-shaped tree)
    v: dict  # second moments
    ef: Optional[dict] = None  # int8 error-feedback residuals (params-shaped, f32)


def tree_map(fn, *trees):
    """``fn`` over the leaves of same-structure dicts, in sorted-key order
    (the reference's ``jax.tree.map``)."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _unzip(tree, n: int) -> tuple:
    """A tree of n-tuples as n trees."""
    return tuple(tree_map(lambda t, i=i: t[i], tree) for i in range(n))


def init_opt_state(params, tcfg: TrainConfig) -> AdamWState:
    dt = getattr(torch, tcfg.optimizer_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    ef = None
    if tcfg.grad_compression == "int8_ef":
        ef = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(zeros, params),
        v=tree_map(zeros, params),
        ef=ef,
    )


def opt_state_specs(pspecs, tcfg: TrainConfig):
    """The reference's PartitionSpec tree for the optimizer state: no
    counterpart on one controller yet."""
    raise not_ported("opt_state_specs (PartitionSpec trees)", "Queue A item 14d")


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 constant on ``like``'s device, made by a fill (no copy from
    the host), so a division by it is an f32 division on the device."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_schedule(step: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """Linear warmup to ``learning_rate``, then cosine decay to a tenth of
    it at ``total_steps``; 0-d f32 on ``step``'s device."""
    s = step.float()
    warm = torch.clamp_max(s / _f32(max(tcfg.warmup_steps, 1), s), 1.0)
    prog = torch.clamp(
        (s - tcfg.warmup_steps) / _f32(max(tcfg.total_steps - tcfg.warmup_steps, 1), s),
        0.0,
        1.0,
    )
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.learning_rate * warm * (0.1 + 0.9 * cos)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, in their
    own dtypes; the norm before clipping, 0-d f32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp_max(_f32(max_norm, gn) / torch.clamp_min(gn, 1e-12), 1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def adamw_update(params, grads, state: AdamWState, tcfg: TrainConfig):
    """One AdamW step. Returns (new_params, new_state, metrics)."""
    with torch.no_grad():
        return _adamw_update(params, grads, state, tcfg)


def _adamw_update(params, grads, state: AdamWState, tcfg: TrainConfig):
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(step, tcfg)
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    s = step.float()
    bc1 = 1.0 - torch.pow(_f32(b1, s), s)
    bc2 = 1.0 - torch.pow(_f32(b2, s), s)

    def upd(p, g, m, v):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mhat = m32 / bc1
        vhat = v32 / bc2
        p32 = p.float()
        p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
        return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    new_params, new_m, new_v = _unzip(tree_map(upd, params, grads, state.m, state.v), 3)
    new_state = AdamWState(step=step, m=new_m, v=new_v, ef=state.ef)
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}


# ---------------------------------------------------------------------------
# Gradient compression (distributed-optimization tricks)
# ---------------------------------------------------------------------------


def compress_grads(grads, mode: Optional[str], ef=None):
    """Compress per-microbatch grads before they are accumulated.

    "bf16": cast. "int8_ef": symmetric per-tensor int8 quantization with
    error feedback — the residual is carried in the optimizer state and
    re-added next time. Returns (compressed, new_ef); an int8 leaf of
    ``compressed`` is the pair (int8 tensor, 0-d f32 scale).
    """
    with torch.no_grad():
        return _compress(grads, mode, ef)


def _compress(grads, mode, ef):
    if mode is None:
        return grads, ef
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), ef
    if mode == "int8_ef":
        def q(g, e):
            g32 = g.float() + e
            scale = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-12) / 127.0
            qg = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
            err = g32 - qg.float() * scale
            return (qg, scale), err

        return _unzip(tree_map(q, grads, ef), 2)
    raise ValueError(mode)


def decompress_accumulate(acc, compressed, mode: Optional[str]):
    """acc (f32 tree) + decompress(compressed), as a new tree."""
    with torch.no_grad():
        if mode is None or mode == "bf16":
            return tree_map(lambda a, g: a + g.float(), acc, compressed)
        if mode == "int8_ef":
            return tree_map(lambda a, qs: a + qs[0].float() * qs[1], acc, compressed)
    raise ValueError(mode)
