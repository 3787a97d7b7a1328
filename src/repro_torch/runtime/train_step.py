"""The training step: fwd+bwd (+ microbatch accumulation, optional
gradient compression) + the AdamW update.

Counterpart of ``repro.runtime.train_step``. The step is a plain closure
over the configs (the port runs eagerly; there is nothing to jit).
Gradients come from ``torch.autograd.grad`` over the parameter leaves, the
counterpart of ``jax.value_and_grad``: each step takes fresh leaves
(``detach().requires_grad_()``) of the state's parameters, and the update
runs under ``torch.no_grad()`` and returns new tensors, so no step's graph
reaches back into an earlier one and the state it was given is left as it
was. ``train_state_specs``, ``batch_pytree_specs`` and ``jit_train_step``
(the reference's PartitionSpec trees and its mesh-jit) raise
``not_ported``: one controller drives the card (ROADMAP.md Queue A item
14d).

A training state's leaves have names, the reference's checkpoint keys
(``ckpt/checkpoint.py:_path_str`` over ``tree_flatten_with_path``):
``params/…``, ``opt/step``, ``opt/m/…``, ``opt/v/…`` and, with int8
compression, ``opt/ef/…``, dict keys in sorted order. ``train_state_leaves``
and ``train_state_from_leaves`` go between a state and that mapping, so
each package restores the other's training checkpoints.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from repro_torch import ckpt, models, not_ported, optim
from repro_torch.api.index import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.model import init_tree
from repro_torch.optim.adamw import tree_leaves, tree_map

SPECS_ITEM = "Queue A item 14d"


class TrainState(NamedTuple):
    params: dict
    opt: optim.AdamWState


def init_train_state(seed_or_generator, mcfg: ModelConfig, tcfg: TrainConfig,
                     device=None) -> TrainState:
    """Random parameters (``models.init_params``) and a zero optimizer
    state on ``device`` (default: the CUDA card; a generator's own device)."""
    params = models.init_params(seed_or_generator, mcfg, device=device)
    return TrainState(params=params, opt=optim.init_opt_state(params, tcfg))


def train_state_template(mcfg: ModelConfig, tcfg: TrainConfig) -> TrainState:
    """``init_train_state``'s tree as meta tensors: the names, shapes and
    dtypes a handover or a restore must match."""
    params = init_tree(None, mcfg)
    return TrainState(params=params, opt=optim.init_opt_state(params, tcfg))


def train_state_specs(mcfg: ModelConfig, tcfg: TrainConfig):
    raise not_ported("train_state_specs (PartitionSpec trees)", SPECS_ITEM)


def batch_pytree_specs(batch_shape_tree):
    raise not_ported("batch_pytree_specs (PartitionSpec trees)", SPECS_ITEM)


def jit_train_step(mcfg: ModelConfig, tcfg: TrainConfig, batch_tree):
    raise not_ported("jit_train_step (the mesh-sharded jit)", SPECS_ITEM)


# ---------------------------------------------------------------------------
# Leaf names (the checkpoint keys of both packages)
# ---------------------------------------------------------------------------


def named_leaves(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a tree of NamedTuples and dicts in jax's
    flattening order: NamedTuple fields in order (``None`` has no leaves),
    dict keys sorted. Works on the reference's trees of numpy arrays too."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        return [(prefix, tree)]
    return [pair for k, v in items for pair in named_leaves(v, f"{prefix}/{k}" if prefix else k)]


def train_state_leaves(state: TrainState) -> dict:
    """{checkpoint key: tensor} of a training state, in the payload order."""
    return dict(named_leaves(state))


def _rebuild(template, leaves: Mapping, prefix: str = ""):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else k)
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, leaves, f"{prefix}/{f}" if prefix else f)
                                for f, v in zip(template._fields, template)))
    return leaves[prefix]


def train_state_from_leaves(leaves: Mapping, template: TrainState, device=None) -> TrainState:
    """The inverse of ``train_state_leaves``: ``template``'s tree with its
    leaves taken from ``leaves`` (key -> tensor, numpy array or
    ``ckpt.Bits``) on ``device`` (default: the CUDA card).

    Every key of the template must be there, with the template leaf's shape
    and dtype, and no other key; every leaf is checked before any is moved,
    and a mismatch raises ValueError naming the leaf, so a directory from
    another configuration never half-loads."""
    dev = resolve_device(device)
    want = train_state_leaves(template)
    missing, extra = sorted(set(want) - set(leaves)), sorted(set(leaves) - set(want))
    if missing or extra:
        raise ValueError(f"training state leaves: missing {missing}, unexpected {extra}")
    host = {}
    for name, spec in want.items():
        t = ckpt.leaf_tensor(leaves[name])
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"training state leaf {name}: {tuple(t.shape)} {t.dtype}, the "
                             f"configuration needs {tuple(spec.shape)} {spec.dtype}")
        host[name] = t
    return _rebuild(template, {k: t.to(dev) for k, t in host.items()})


# ---------------------------------------------------------------------------
# The step
# ---------------------------------------------------------------------------


def _value_and_grad(params, batch: dict, mcfg: ModelConfig):
    """(loss, grads) of ``forward_train`` at ``params``, through fresh leaves."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss = models.forward_train(live, batch, mcfg)
        grads = iter(torch.autograd.grad(loss, tree_leaves(live)))
    return loss.detach(), tree_map(lambda _: next(grads), live)


def _microbatch(batch: dict, i: int, k: int) -> dict:
    """Microbatch i of k: batch dim 0, or dim 1 of the (3, B, S) positions."""
    out = {}
    for name, x in batch.items():
        bdim = 1 if name == "positions" else 0
        mb = x.shape[bdim] // k
        out[name] = x.narrow(bdim, i * mb, mb)
    return out


def make_train_step(mcfg: ModelConfig, tcfg: TrainConfig):
    """Returns train_step(state, batch) -> (state, metrics); ``batch`` holds
    tensors on the state's device, ``metrics`` 0-d tensors there (loss,
    grad_norm, lr)."""

    def train_step(state: TrainState, batch: dict):
        params = state.params
        mode = tcfg.grad_compression
        if tcfg.microbatch > 1:
            k = tcfg.microbatch
            ef = state.opt.ef
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                           params)
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.opt.step.device)
            for i in range(k):
                loss, grads = _value_and_grad(params, _microbatch(batch, i, k), mcfg)
                comp, ef = optim.compress_grads(grads, mode, ef)
                acc = optim.decompress_accumulate(acc, comp, mode)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda g: g / k, acc)
            loss = loss_sum / k
            opt_state = state.opt._replace(ef=ef)
        else:
            loss, grads = _value_and_grad(params, batch, mcfg)
            if mode == "bf16":
                grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
            opt_state = state.opt

        new_params, new_opt, metrics = optim.adamw_update(params, grads, opt_state, tcfg)
        metrics = dict(metrics, loss=loss)
        return TrainState(params=new_params, opt=new_opt), metrics

    return train_step
