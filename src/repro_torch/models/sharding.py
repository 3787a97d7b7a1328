"""Mesh context and logical sharding rules for the model/runtime stack.

Counterpart of ``repro.models.sharding``. Axes: ("pod", "data", "model") —
production meshes (2, 16, 16) and (16, 16) (the single-pod mesh has no
"pod" axis; the rules degrade gracefully). Batch shards over ("pod",
"data"); tensor-parallel dims over "model"; FSDP parameter sharding over
"data" on a rule-selected axis.

One controller holds each tensor whole on one device, so nothing here moves
a tensor: the spec trees are the layout the reference's program would
shard by, computed for the dry run (``launch/compile.py``: per-device
bytes) and for the mesh-run MoE impls (``models/moe.py``: the EP axis and
the batch axes). The port's own pieces:

  * :class:`PartitionSpec`, a tuple-like record with jax's equality rules
    (entries canonicalized: a one-name tuple is the bare name, an empty
    tuple is ``None``; trailing ``None``s count; equal to a plain tuple of
    the same canonical entries);
  * :class:`NamedSharding`, a plain ``(mesh, spec)`` record;
  * ``maybe_shard`` is the identity, with or without a mesh;
  * a mesh is ``core.distributed.Mesh`` or any object with ``axis_names``
    and a ``shape`` mapping axis name -> size.
"""

from __future__ import annotations

import contextlib
from typing import Any, NamedTuple, Optional, Sequence


def _canonical(entry):
    """jax's partition canonicalization: a list is a tuple, a one-name tuple
    is the bare name, an empty tuple is None."""
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        if len(entry) == 1:
            return entry[0]
        return entry if entry else None
    return entry


class PartitionSpec:
    """How each dim of an array splits over mesh axes: per dim ``None``, an
    axis name, or a tuple of axis names (the stand-in for
    ``jax.sharding.PartitionSpec``)."""

    __slots__ = ("_partitions",)

    def __init__(self, *partitions):
        self._partitions = tuple(_canonical(p) for p in partitions)

    def __iter__(self):
        return iter(self._partitions)

    def __len__(self) -> int:
        return len(self._partitions)

    def __getitem__(self, i):
        return self._partitions[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self._partitions == other._partitions
        if isinstance(other, tuple):
            return self._partitions == tuple(_canonical(o) for o in other)
        return False

    def __hash__(self) -> int:
        return hash(self._partitions)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._partitions!r}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec bound to a mesh (the stand-in for ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec


_ACTIVE_MESH = None


def set_mesh(mesh) -> None:
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh():
    return _ACTIVE_MESH


@contextlib.contextmanager
def use_mesh(mesh):
    global _ACTIVE_MESH
    prev, _ACTIVE_MESH = _ACTIVE_MESH, mesh
    try:
        yield
    finally:
        _ACTIVE_MESH = prev


def _filter_spec(spec: Sequence) -> PartitionSpec:
    """Drop axis names that don't exist in the active mesh (e.g. 'pod' on 1-pod)."""
    mesh = _ACTIVE_MESH
    names = set(mesh.axis_names) if mesh is not None else set()

    def keep(entry):
        entry = resolve_entry(entry)
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(e for e in entry if e in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(keep(e) for e in spec))


def sharding(*spec) -> Optional[NamedSharding]:
    """NamedSharding for the active mesh (None if no mesh)."""
    if _ACTIVE_MESH is None:
        return None
    return NamedSharding(_ACTIVE_MESH, _filter_spec(spec))


def _sanitize_entry(mesh, entry, dim: int):
    """Keep a spec entry only if it divides the dim; tuples degrade greedily
    (e.g. ("pod","data") on batch 8 with 2x16 mesh -> ("pod",))."""
    entry = resolve_entry(entry)
    if entry is None:
        return None
    if isinstance(entry, (tuple, list)):
        kept = []
        prod = 1
        for e in entry:
            if e in mesh.axis_names and dim % (prod * mesh.shape[e]) == 0:
                kept.append(e)
                prod *= mesh.shape[e]
        return tuple(kept) if kept else None
    if entry not in mesh.axis_names:
        return None
    return entry if dim % mesh.shape[entry] == 0 else None


def sanitize_spec(spec, shape: tuple, mesh=None) -> PartitionSpec:
    """Shape-aware spec cleanup: drop axes that don't exist in the mesh or
    don't divide the corresponding dim (kv=1 heads, batch=1, vocab 504...)."""
    mesh = mesh or _ACTIVE_MESH
    if mesh is None:
        return P()
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    return P(*(_sanitize_entry(mesh, e, d) for e, d in zip(entries, shape)))


def spec_tree_map(fn, spec_tree, *trees):
    """``fn(spec, *leaves)`` over a spec tree and trees of the same structure
    (dicts and NamedTuples; ``None`` is an empty subtree): the counterpart
    of ``jax.tree.map(..., is_leaf=lambda s: isinstance(s, P))``."""
    if isinstance(spec_tree, PartitionSpec):
        return fn(spec_tree, *trees)
    if spec_tree is None:
        return None
    if isinstance(spec_tree, dict):
        return {k: spec_tree_map(fn, v, *(t[k] for t in trees)) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(spec_tree_map(fn, v, *(t[i] for t in trees))
                                 for i, v in enumerate(spec_tree)))
    raise TypeError(f"not a spec tree node: {type(spec_tree).__name__}")


def sanitize_spec_tree(spec_tree, shape_tree, mesh=None):
    """Walk a (PartitionSpec tree, shape tree) pair and sanitize each leaf
    (a shape-tree leaf is anything with ``.shape``: a tensor, a meta tensor)."""
    return spec_tree_map(lambda s, x: sanitize_spec(s, tuple(x.shape), mesh), spec_tree,
                         shape_tree)


def maybe_shard(x, *spec):
    """The identity: one controller holds ``x`` whole on its device, with or
    without an active mesh (the reference's ``with_sharding_constraint``
    only places the value)."""
    return x


# ---------------------------------------------------------------------------
# Canonical logical specs (referenced by model + runtime code)
#
# These are SENTINELS resolved against the active sharding policy, so one
# model codebase supports both parallelism layouts:
#   megatron  (default): batch over ("pod","data"); TP over "model"
#   fsdp_only (dp_over_model=True): batch over ("pod","data","model") — the
#             model axis becomes extra data parallelism; TP constraints
#             dissolve (params replicate across "model", still ZeRO over
#             "data"); EP stays on "model" (experts must shard somewhere).
# ---------------------------------------------------------------------------

BATCH = "@batch"
TP = "@tp"
FSDP = "@fsdp"
EP = "@ep"  # expert parallelism — survives fsdp_only mode
SEQ_SP = "@tp"  # sequence parallelism rides the tp axis

_POLICY = {
    "@batch": ("pod", "data"),
    "@tp": "model",
    "@fsdp": "data",
    "@ep": "model",
}


def set_policy(dp_over_model: bool = False, fsdp: bool = True) -> None:
    """Select the parallelism layout (see above).

    fsdp=False replicates parameters over the data axis (the serving layout:
    weights live TP-sharded, no per-step FSDP gathers).
    """
    _POLICY["@batch"] = ("pod", "data", "model") if dp_over_model else ("pod", "data")
    _POLICY["@tp"] = None if dp_over_model else "model"
    _POLICY["@fsdp"] = "data" if fsdp else None


def resolve_entry(entry):
    """Sentinel -> concrete mesh-axis entry under the active policy."""
    if isinstance(entry, str) and entry.startswith("@"):
        return _POLICY[entry]
    if isinstance(entry, (tuple, list)):
        out = []
        for e in entry:
            r = resolve_entry(e)
            if r is None:
                continue
            out.extend(r) if isinstance(r, (tuple, list)) else out.append(r)
        return tuple(out) if out else None
    return entry


def batch_spec(*rest) -> tuple:
    return (BATCH, *rest)


def shards(spec, mesh) -> int:
    """How many pieces a sanitized ``spec`` cuts an array into on ``mesh``:
    the product of the sizes of the mesh axes it names."""
    n = 1
    for entry in spec:
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None:
                n *= mesh.shape[name]
    return n
