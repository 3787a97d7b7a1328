"""The port's PartitionSpec trees against the JAX package's (CPU).

``models.sharding`` (its ``PartitionSpec`` compares as jax's does), the
spec trees (``param_specs``, ``cache_specs``, ``train_state_specs``,
``opt_state_specs``, ``batch_pytree_specs``) for all ten archs at full
width, their sanitized forms on duck-typed ``pod1``/``pod2`` meshes for
every runnable (arch × shape) cell under each policy ``lower_cell`` sets
(the bundles' own configs and ``dryrun.optimized_overrides``), and the
per-device argument bytes ``lower_cell`` sums, against the same arithmetic
on the reference's sanitized trees. Spec arithmetic only: no step runs
here (``tests/test_torch_dryrun.py`` runs them, reduced). Specs are
compared as tuples of their canonical entries and with the port's own
equality.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.models as jmodels
import repro.models.sharding as jsh
import repro.optim as joptim
import repro.runtime.train_step as jts
from repro.launch import specs as jspecs
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.models.sharding as tsh
import repro_torch.optim as toptim
import repro_torch.runtime.train_step as tts
from repro_torch.launch import compile as tcompile
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh

ARCHS = tconfigs.list_archs()
POD1 = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16})
POD2 = types.SimpleNamespace(axis_names=("pod", "data", "model"),
                             shape={"pod": 2, "data": 16, "model": 16})
MESHES = {"pod1": POD1, "pod2": POD2}


@pytest.fixture(autouse=True)
def _default_policies():
    yield
    jsh.set_policy()
    tsh.set_policy()


def _ref_flat(tree) -> dict:
    """{keystr path: tuple of canonical entries} of a reference spec tree."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda s: isinstance(s, JP))[0]
    return {jax.tree_util.keystr(p): s for p, s in leaves}


def _port_flat(tree, path="") -> dict:
    """The same for a port spec tree: dict keys as ``['k']``, NamedTuple
    fields as ``.f`` (jax's key strings); ``None`` has no leaves."""
    if isinstance(tree, tsh.PartitionSpec):
        return {path: tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = ((f"{path}[{k!r}]", v) for k, v in tree.items())
    else:
        items = ((f"{path}.{f}", v) for f, v in zip(tree._fields, tree))
    return {p: s for q, v in items for p, s in _port_flat(v, q).items()}


def _assert_same_specs(port_tree, ref_tree):
    want, got = _ref_flat(ref_tree), _port_flat(port_tree)
    assert sorted(got) == sorted(want)
    for path, spec in want.items():
        assert tuple(got[path]) == tuple(spec), (path, got[path], spec)
        assert got[path] == tuple(spec), path


def _configs(arch, **overrides):
    j = jconfigs.get_bundle(arch)
    t = tconfigs.get_bundle(arch)
    if overrides:
        j = dataclasses.replace(j, model=dataclasses.replace(j.model, **overrides))
        t = dataclasses.replace(t, model=dataclasses.replace(t.model, **overrides))
    return j, t


# ---------------------------------------------------------------------------
# PartitionSpec and the sanitizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("a,b", [
    (("a", None), ("a",)), ((None,), ()), ((("a",),), ("a",)), (((),), (None,)),
    ((("a", "b"),), (("a", "b"),)), ((["a", "b"],), (("a", "b"),)), (("a",), ("b",)),
    ((("a", "b"),), (("b", "a"),)), ((None, "a"), ("a", None)),
])
def test_partition_spec_equality_is_jax_s(a, b):
    """jax 0.9's traps: trailing Nones count, P(None) != P(), a one-name
    tuple is the bare name, an empty tuple is None; equality with a plain
    tuple canonicalizes it; equal specs hash alike."""
    want = JP(*a) == JP(*b)
    assert (tsh.P(*a) == tsh.P(*b)) == want
    assert tuple(tsh.P(*a)) == tuple(JP(*a)) and len(tsh.P(*a)) == len(JP(*a))
    assert (tsh.P(*a) == tuple(b)) == (JP(*a) == tuple(b))
    if want:
        assert hash(tsh.P(*a)) == hash(tsh.P(*b))


def test_sanitize_spec_divisibility():
    mesh = tmesh.make_local_mesh(devices=[torch.device("cpu")])  # (1, 1): sizes 1
    assert tsh.sanitize_spec(tsh.P("data", "model"), (8, 8), mesh) == tsh.P("data", "model")


def test_sanitize_spec_drops_nondivisible():
    """The reference's own cases (tests/test_runtime_units.py)."""
    cpu = torch.device("cpu")
    mesh = tmesh.make_local_mesh(2, 4, devices=[cpu] * 8)
    assert tsh.sanitize_spec(tsh.P("data", "model"), (3, 8), mesh) == tsh.P(None, "model")
    from repro_torch.core.distributed import make_mesh

    mesh2 = make_mesh((2, 4), ("pod", "data"), devices=[cpu] * 8)
    assert tsh.sanitize_spec(tsh.P(("pod", "data")), (2,), mesh2) == tsh.P(("pod",))
    assert tsh.sanitize_spec(tsh.P(("pod", "data")), (8,), mesh2) == tsh.P(("pod", "data"))
    assert tsh.sanitize_spec(tsh.P("nope"), (8,), mesh2) == tsh.P(None)
    assert tsh.sanitize_spec(tsh.P("data"), (8,), None) == tsh.P()  # no mesh


@pytest.mark.parametrize("dp_over_model,fsdp", [(False, True), (True, True), (False, False),
                                                (True, False)])
def test_policy_resolution_and_filter_match_the_reference(dp_over_model, fsdp):
    entries = [tsh.BATCH, tsh.TP, tsh.FSDP, tsh.EP, tsh.SEQ_SP, (tsh.BATCH, tsh.TP), None,
               "data", ("pod", tsh.EP)]
    jsh.set_policy(dp_over_model=dp_over_model, fsdp=fsdp)
    tsh.set_policy(dp_over_model=dp_over_model, fsdp=fsdp)
    for e in entries:
        assert tsh.resolve_entry(e) == jsh.resolve_entry(e), e
    for mesh in MESHES.values():
        with jsh.use_mesh(mesh), tsh.use_mesh(mesh):
            assert tuple(tsh._filter_spec(entries)) == tuple(jsh._filter_spec(entries))
            assert tsh.get_mesh() is mesh
            got = tsh.sharding(tsh.BATCH, None)
            assert got.mesh is mesh and got.spec == tuple(jsh._filter_spec((jsh.BATCH, None)))
    assert tsh.get_mesh() is None and tsh.sharding(tsh.BATCH) is None
    assert tsh.batch_spec(None, tsh.TP) == jsh.batch_spec(None, jsh.TP)


def test_maybe_shard_is_the_identity():
    x = torch.arange(12.0).reshape(3, 4)
    assert tsh.maybe_shard(x, tsh.BATCH, tsh.TP) is x
    with tsh.use_mesh(tmesh.make_local_mesh(2, 1, devices=[torch.device("cpu")] * 2)):
        assert tsh.maybe_shard(x, tsh.BATCH, tsh.TP) is x


# ---------------------------------------------------------------------------
# the spec trees at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_specs_match_the_reference(arch):
    j, t = _configs(arch)
    _assert_same_specs(tmodels.param_specs(t.model), jmodels.param_specs(j.model))
    if not t.model.encoder_only:
        _assert_same_specs(tmodels.cache_specs(t.model), jmodels.cache_specs(j.model))
    for over in ({"embed_table_spec": "dm_data"}, {"cache_spec_mode": "heads_model"}):
        j2, t2 = _configs(arch, **over)
        _assert_same_specs(tmodels.param_specs(t2.model), jmodels.param_specs(j2.model))
        if not t.model.encoder_only:
            _assert_same_specs(tmodels.cache_specs(t2.model), jmodels.cache_specs(j2.model))


@pytest.mark.parametrize("compression", [None, "int8_ef"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_state_specs_match_the_reference(arch, compression):
    j, t = _configs(arch)
    jtr = jconfigs.TrainConfig(grad_compression=compression)
    ttr = tconfigs.TrainConfig(grad_compression=compression)
    _assert_same_specs(tts.train_state_specs(t.model, ttr), jts.train_state_specs(j.model, jtr))
    pj = jmodels.param_specs(j.model)
    _assert_same_specs(toptim.opt_state_specs(tmodels.param_specs(t.model), ttr),
                       joptim.opt_state_specs(pj, jtr))


@pytest.mark.parametrize("arch", ["gemma3-1b", "hubert-xlarge", "qwen2-vl-2b"])
def test_batch_pytree_specs_match_the_reference(arch):
    j, _ = _configs(arch)
    for make in (jspecs.train_batch, jspecs.prefill_batch):
        jb = make(j.model, 256, 4096)
        tb = {k: torch.empty(v.shape, device="meta") for k, v in jb.items()}
        _assert_same_specs(tts.batch_pytree_specs(tb), jts.batch_pytree_specs(jb))


# ---------------------------------------------------------------------------
# sanitized trees and per-device bytes: every runnable cell, both meshes
# ---------------------------------------------------------------------------


def _ref_cell_trees(bundle, shape):
    """The reference's (spec tree, shape tree) pairs of a cell, as its
    ``lower_cell`` builds them (abstract shapes by ``jax.eval_shape``)."""
    mcfg, tcfg = bundle.model, bundle.train
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = jax.eval_shape(lambda: jts.init_train_state(jax.random.PRNGKey(0), mcfg, tcfg))
        batch = jspecs.train_batch(mcfg, B, S)
        return [(jts.train_state_specs(mcfg, tcfg), state),
                (jts.batch_pytree_specs(batch), batch)]
    params = jax.eval_shape(lambda: jmodels.init_params(jax.random.PRNGKey(0), mcfg))
    if shape.kind == "prefill":
        batch = jspecs.prefill_batch(mcfg, B, S)
        return [(jmodels.param_specs(mcfg), params), (jts.batch_pytree_specs(batch), batch)]
    batch = jspecs.decode_batch(mcfg, B, S - 1)
    caches = jax.eval_shape(lambda: jmodels.init_caches(B, S, mcfg))
    return [(jmodels.param_specs(mcfg), params), ({"token": JP(jsh.BATCH), "pos": JP(jsh.BATCH)},
                                                 batch), (jmodels.cache_specs(mcfg), caches)]


def _ref_bytes(clean, shapes, mesh) -> int:
    total = 0
    specs = jax.tree.leaves(clean, is_leaf=lambda s: isinstance(s, JP))
    for spec, leaf in zip(specs, jax.tree.leaves(shapes)):
        n = 1
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                if a is not None:
                    n *= mesh.shape[a]
        total += int(np.prod(leaf.shape)) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("mesh_name", ["pod1", "pod2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_trees_and_argument_bytes_match_the_reference(arch, mesh_name):
    """Every runnable shape of ``arch`` at full width, plain and with the
    ``--optimized`` overrides (each cell under the policy ``lower_cell``
    sets): the sanitized state / params, batch and cache trees leaf for
    leaf, and the per-device argument bytes."""
    mesh = MESHES[mesh_name]
    tbundle = tconfigs.get_bundle(arch)
    for shape in tbundle.runnable_shapes():
        for optimized in (False, True):
            over = tdryrun.optimized_overrides(arch, shape.kind) if optimized else {}
            jb, tb = _configs(arch, **over)
            jcell = _ref_cell_trees(jb, jconfigs.SHAPES[shape.name])
            serve_fsdp = not (shape.kind in ("prefill", "decode")
                              and jb.model.serve_param_layout == "replicated")
            jsh.set_policy(dp_over_model=jb.model.dp_over_model, fsdp=serve_fsdp)
            try:
                jclean = [jsh.sanitize_spec_tree(s, x, mesh) for s, x in jcell]
                want_bytes = sum(_ref_bytes(c, x, mesh) for c, (_, x) in zip(jclean, jcell))
            finally:
                jsh.set_policy()
            cell = tcompile.lower_cell(tb, shape, mesh, run_step=False)
            assert len(cell.specs) == len(jclean)
            for got, want in zip(cell.specs, jclean):
                _assert_same_specs(got, want)
            assert cell.argument_size_in_bytes == want_bytes, (shape.name, optimized)
            assert tsh._POLICY == {"@batch": ("pod", "data"), "@tp": "model",
                                   "@fsdp": "data", "@ep": "model"}  # reset after the cell
