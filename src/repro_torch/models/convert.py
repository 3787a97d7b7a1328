"""Handover from the reference: its parameter and cache trees as the port's.

The port cannot replay ``jax.random``, so every parity test builds the
reference's parameters (and, for a decode from the reference's prefill, its
caches), converts their leaves to numpy arrays, and hands them over here —
as ``Index.from_numpy`` does for an index. The trees are the reference's:
``{"embed": {"table"}, "lm_head": {"w"}, "units": {"p{i}": block},
"tail": {"p{i}": block}, "ln_f": {"scale"}}`` with the stacked ``units``
leaves ``(n_units, …)``, and caches ``{"units": {"p{i}": KVCache},
"tail": {"p{i}": KVCache}}``. A training state (``train_state_from_jax``)
is the reference's ``TrainState`` — its parameters and its ``AdamWState``
(step, moments in ``optimizer_dtype``, int8 error feedback) — leaf for leaf
under the names both packages' checkpoints use. Nothing here imports the
reference.
"""

from __future__ import annotations

import torch

from repro_torch import ckpt
from repro_torch.api.index import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.model import check_ported, init_tree


def params_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's parameters from the reference's ``init_params`` tree as
    numpy arrays, on ``device`` (default: the CUDA card). Raises ValueError
    naming the leaf when the tree, a shape or a dtype differs from the one
    ``init_params(…, cfg)`` makes."""
    dev = resolve_device(device)
    want = init_tree(None, cfg)  # meta tensors: shapes and dtypes only

    def convert(got, spec, path):
        if isinstance(spec, dict):
            if not isinstance(got, dict) or set(got) != set(spec):
                have = sorted(got) if isinstance(got, dict) else type(got).__name__
                raise ValueError(f"params{path}: keys {have}, config needs {sorted(spec)}")
            return {k: convert(got[k], spec[k], f"{path}/{k}") for k in spec}
        t = ckpt.leaf_tensor(got)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"params{path}: {tuple(t.shape)} {t.dtype}, config needs "
                             f"{tuple(spec.shape)} {spec.dtype}")
        return t.to(dev)

    return convert(tree, want, "")


def caches_from_jax(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The port's decode caches from the reference's (``forward_prefill``'s
    or ``init_caches``'s) as numpy arrays: each layer's ``KVCache`` (or any
    object with ``k``, ``v``, ``k_pos``) becomes an ``attention.KVCache``."""
    check_ported(cfg)
    dev = resolve_device(device)
    groups = {"units": cfg.scan_unit if cfg.resolved_units else (), "tail": cfg.tail}
    out = {}
    for group, kinds in groups.items():
        if not kinds:
            continue
        out[group] = {}
        for i in range(len(kinds)):
            c = tree[group][f"p{i}"]
            k, v, k_pos = (ckpt.leaf_tensor(getattr(c, f)).to(dev) for f in ("k", "v", "k_pos"))
            if k.shape != v.shape or k_pos.shape != k.shape[:-2] or k_pos.dtype != torch.int32:
                raise ValueError(f"caches/{group}/p{i}: k {tuple(k.shape)}, v {tuple(v.shape)}, "
                                 f"k_pos {tuple(k_pos.shape)} {k_pos.dtype}")
            out[group][f"p{i}"] = attention.KVCache(k=k, v=v, k_pos=k_pos)
    return out


def train_state_from_jax(tree, mcfg: ModelConfig, tcfg, device=None):
    """The port's ``TrainState`` from the reference's (``init_train_state``'s
    or a training step's, its leaves as numpy arrays), on ``device``
    (default: the CUDA card). Every leaf's name, shape and dtype is checked
    against ``init_train_state(…, mcfg, tcfg)``'s, bf16 moments and the
    int8 error feedback included; a mismatch raises ValueError naming it."""
    from repro_torch.runtime import train_step

    return train_step.train_state_from_leaves(
        dict(train_step.named_leaves(tree)), train_step.train_state_template(mcfg, tcfg),
        device=device)
