"""Abstract lowering of every (arch × shape × mesh) cell — shared by the dry
run and the chip check.

Counterpart of ``repro.launch.compile``. Everything is abstract: meta-tensor
inputs (``init_tree(None, cfg)``, ``train_state_template``, ``launch.specs``),
spec trees sanitized against the mesh. One controller has no
``jax.jit(...).lower()``: its counterpart here runs the cell's step on the
meta tensors at the cell's global shape, which proves the program is
shape-coherent at that size without allocating it. The run counts its aten
ops and, with ``analysis.audit.Tracker``, the peak of the bytes its ops
return that are alive at once: the whole program's live bytes at the
global shape, a lower bound on what one device holding all of it would
need — never a per-device figure (the card's allocator also holds
autograd's saved tensors and its own rounding).

Per-device bytes are each leaf's bytes over the product of the mesh axes
its sanitized spec names. Arguments: the state (train) or the parameters,
the batch and, for decode, the caches. Outputs: a leaf with a spec tree in
the cell (the new train state; the caches) by that spec; the others
(metrics, logits, tokens) whole on every device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import torch
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.audit import Tracker
from repro_torch.configs.base import ArchBundle, ShapeConfig
from repro_torch.launch import specs as input_specs
from repro_torch.models import model as model_lib
from repro_torch.models.sharding import (
    BATCH,
    P,
    sanitize_spec_tree,
    set_policy,
    shards,
    spec_tree_map,
    use_mesh,
)
from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step
from repro_torch.runtime.train_step import (
    batch_pytree_specs,
    make_train_step,
    train_state_specs,
    train_state_template,
)


def abstract_train_state(bundle: ArchBundle):
    return train_state_template(bundle.model, bundle.train)


def abstract_params(bundle: ArchBundle) -> dict:
    return model_lib.init_tree(None, bundle.model)


def abstract_caches(bundle: ArchBundle, shape: ShapeConfig) -> dict:
    return model_lib.init_caches(shape.global_batch, shape.seq_len, bundle.model, device="meta")


@dataclasses.dataclass
class LoweredCell:
    """What ``lower_cell`` proves and measures for one cell."""

    kind: str
    args: tuple  # the step's abstract (meta) arguments
    specs: tuple  # their spec trees, sanitized against the mesh
    argument_size_in_bytes: int  # per device
    outputs: Any = None  # the step's outputs, meta tensors (None: no meta run)
    output_size_in_bytes: Optional[int] = None  # per device
    aten_ops: Optional[int] = None
    whole_program_live_bytes_peak: Optional[int] = None  # Tracker, global shape
    meta_run_s: Optional[float] = None
    meta_run_reused: bool = False


def per_device_bytes(spec_tree, tree, mesh) -> int:
    """Sum over the leaves of ``tree`` of its bytes over the number of pieces
    its (sanitized) spec cuts it into on ``mesh``."""
    total = 0

    def add(spec, leaf):
        nonlocal total
        total += leaf.numel() // shards(spec, mesh) * leaf.element_size()

    spec_tree_map(add, spec_tree, tree)
    return total


def _whole(tree) -> Any:
    """A spec tree replicating every tensor leaf of ``tree`` (``P()``)."""
    if isinstance(tree, torch.Tensor):
        return P()
    if isinstance(tree, dict):
        return {k: _whole(v) for k, v in tree.items()}
    return None


def _run_key(bundle: ArchBundle, shape: ShapeConfig, mesh):
    """What a cell's meta run depends on: the config and the shape, and the
    mesh and policy only when an MoE layer runs a mesh impl (``maybe_shard``
    is the identity, so the layout fields change no op)."""
    cfg = bundle.model
    if cfg.moe is not None and cfg.moe_impl != "gspmd":
        return (cfg, bundle.train, shape, tuple(mesh.axis_names), tuple(mesh.shape.values()))
    layout_free = dataclasses.replace(cfg, dp_over_model=False, serve_param_layout="fsdp",
                                      embed_table_spec="vocab_model",
                                      cache_spec_mode="seq_model")
    return (layout_free, bundle.train, shape)


_MISS = object()
_SCALARS = {int, float, bool, str, type(None), torch.dtype, torch.device, torch.layout,
            torch.memory_format}


def _signature(x, tensors: list):
    """A hashable description of an op argument that fixes its outputs'
    shapes, strides and dtypes (tensors by shape, stride and dtype; other
    values by type and value), collecting its tensors; None when it has no
    such description (a tensor off the meta device, an unknown object)."""
    tp = type(x)
    if tp in _SCALARS:
        return (tp, x)
    if tp is list or tp is tuple:
        parts = []
        for v in x:
            p = _signature(v, tensors)
            if p is None:
                return None
            parts.append(p)
        return tuple(parts)
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            return None
        tensors.append(x)
        return (x.shape, x.stride(), x.dtype)
    if tp is dict:
        return _signature(sorted(x.items()), tensors)
    return None


def _fresh_layouts(out, inputs):
    """(shape, stride, dtype) of each output when every output is a fresh,
    exactly sized storage of its own, else None (a view, an alias of an
    input, a piece of a larger buffer: those must run)."""
    outs = out if isinstance(out, tuple) else (out,)
    if not outs or not all(isinstance(t, torch.Tensor) and t.is_meta for t in outs):
        return None
    seen = {t.untyped_storage()._cdata for t in inputs}
    layouts = []
    for t in outs:
        key = t.untyped_storage()._cdata
        exact = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
        if (key in seen or t.storage_offset()
                or t.untyped_storage().nbytes() != exact.untyped_storage().nbytes()):
            return None
        seen.add(key)
        layouts.append((tuple(t.shape), t.stride(), t.dtype))
    return tuple(layouts), isinstance(out, tuple)


class MetaTracker(Tracker):
    """The Tracker over meta tensors, with every op call's fresh outputs
    memoized by the call's signature (``_signature``): a repeated call makes
    its outputs with ``torch.empty_strided`` instead of running the meta
    kernel again. Many meta kernels are Python reference implementations
    (~0.2 ms an elementwise op), and a step's loops repeat the same calls;
    the first call of each signature runs the op, so the outputs' shapes,
    strides and dtypes, the aliasing the Tracker charges by, and every
    error are the op's own."""

    def __init__(self):
        super().__init__()
        self.layouts: dict = {}  # call signature -> its outputs' layouts, or None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs: list = []
        sig = _signature((args, kwargs), inputs)
        if sig is None:
            return super().__torch_dispatch__(func, types, args, kwargs)
        key = (func, sig)
        hit = self.layouts.get(key, _MISS)
        if hit is _MISS:
            out = func(*args, **kwargs)
            self.layouts[key] = _fresh_layouts(out, inputs)
        elif hit is None:
            out = func(*args, **kwargs)
        else:
            layouts, is_tuple = hit
            outs = tuple(torch.empty_strided(s, st, dtype=d, device="meta")
                         for s, st, d in layouts)
            out = outs if is_tuple else outs[0]
        if isinstance(out, torch.Tensor):
            outputs = [out]
        elif isinstance(out, tuple) and all(isinstance(t, torch.Tensor) for t in out):
            outputs = list(out)
        else:
            outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self._account(func, inputs, outputs)
        return out


def _meta_run(step, args, grad: bool):
    """Run ``step(*args)`` on meta tensors under a MetaTracker."""
    tracker = MetaTracker()
    t0 = time.perf_counter()
    with contextlib.nullcontext() if grad else torch.no_grad(), tracker:
        out = step(*args)
    return out, tracker.ops, tracker.peak, time.perf_counter() - t0


def lower_cell(bundle: ArchBundle, shape: ShapeConfig, mesh, run_step: bool = True,
               runs: Optional[dict] = None) -> LoweredCell:
    """Abstract inputs and sanitized spec trees of one cell on ``mesh``, its
    per-device argument bytes, and (``run_step``) the cell's step run on meta
    tensors at its global shape under ``use_mesh(mesh)``: output bytes,
    aten ops, the Tracker's peak. ``runs`` memoizes meta runs across calls
    (see ``_run_key``)."""
    mcfg = bundle.model
    serve_fsdp = not (
        shape.kind in ("prefill", "decode") and mcfg.serve_param_layout == "replicated"
    )
    set_policy(dp_over_model=mcfg.dp_over_model, fsdp=serve_fsdp)
    try:
        return _lower_cell_inner(bundle, shape, mesh, run_step, runs)
    finally:
        set_policy()


def _lower_cell_inner(bundle, shape, mesh, run_step, runs) -> LoweredCell:
    mcfg, tcfg = bundle.model, bundle.train
    B, S = shape.global_batch, shape.seq_len
    with use_mesh(mesh):
        if shape.kind == "train":
            state = abstract_train_state(bundle)
            batch = input_specs.train_batch(mcfg, B, S)
            args = (state, batch)
            trees = (train_state_specs(mcfg, tcfg), batch_pytree_specs(batch))
            step, out_trees = make_train_step(mcfg, tcfg), (trees[0], None)
        elif shape.kind == "prefill":
            args = (abstract_params(bundle), input_specs.prefill_batch(mcfg, B, S))
            trees = (model_lib.param_specs(mcfg), batch_pytree_specs(args[1]))
            out_caches = None if mcfg.encoder_only else model_lib.cache_specs(mcfg)
            step, out_trees = make_prefill_step(mcfg), (None, out_caches)
        else:  # decode: one new token against a cache of shape.seq_len
            batch = input_specs.decode_batch(mcfg, B, S - 1)
            args = (abstract_params(bundle), batch, abstract_caches(bundle, shape))
            cspecs = model_lib.cache_specs(mcfg)
            trees = (model_lib.param_specs(mcfg), {"token": P(BATCH), "pos": P(BATCH)}, cspecs)
            step, out_trees = make_decode_step(mcfg), (None, None, cspecs)
        clean = tuple(sanitize_spec_tree(t, a, mesh) for t, a in zip(trees, args))
        cell = LoweredCell(
            kind=shape.kind, args=args, specs=clean,
            argument_size_in_bytes=sum(per_device_bytes(t, a, mesh)
                                       for t, a in zip(clean, args)),
        )
        if not run_step:
            return cell
        key = _run_key(bundle, shape, mesh)
        if runs is not None and key in runs:
            got, cell.meta_run_reused = runs[key], True
        else:
            got = _meta_run(step, args, grad=shape.kind == "train")
            if runs is not None:
                runs[key] = got
        out, cell.aten_ops, cell.whole_program_live_bytes_peak, cell.meta_run_s = got
        cell.outputs = out
        out_bytes = 0
        for tree, o in zip(out_trees, out):
            spec = _whole(o) if tree is None else sanitize_spec_tree(tree, o, mesh)
            out_bytes += per_device_bytes(spec, o, mesh)
        cell.output_size_in_bytes = out_bytes
        return cell
