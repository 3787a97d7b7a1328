"""The port's package namespaces against the reference's (CPU):
``repro_torch.core``, ``repro_torch.api``, ``repro_torch.analysis``,
``repro_torch.configs``, ``repro_torch.models``, ``repro_torch.runtime``,
``repro_torch.optim``, ``repro_torch.data`` and ``repro_torch.ckpt`` export
every name their reference packages export (``ShardedIndex`` too) but those
``HELD_BACK``
names a later ROADMAP.md item ports, the legacy
shims warn as the reference's do, and each shim's answer equals
``Index.query``'s."""

import warnings

import numpy as np
import pytest
import torch

import repro.analysis as janalysis
import repro.api as japi
import repro.ckpt as jckpt
import repro.configs as jconfigs
import repro.core as jcore
import repro.data as jdata
import repro.models as jmodels
import repro.optim as joptim
import repro.runtime as jruntime
import repro_torch.analysis as tanalysis
import repro_torch.api as tapi
import repro_torch.ckpt as tckpt
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.models as tmodels
import repro_torch.optim as toptim
import repro_torch.runtime as truntime

# names the port exports beyond the reference's
PORT_ONLY = {"core": {"index_from_numpy"}, "api": {"validate_query_args"},
             "analysis": {"library_loads"}, "configs": set(),
             "models": {"params_from_jax", "caches_from_jax", "train_state_from_jax"},
             "runtime": {"SimulatedFailure", "StragglerMonitor", "train_state_leaves",
                         "train_state_from_leaves"},
             "optim": set(), "data": set(), "ckpt": {"BFLOAT16", "Bits", "host_copy", "leaf_tensor"}}
# the reference's names the port holds back (PartitionSpec trees), by the
# ROADMAP.md item that ports them: Queue A item 14d
HELD_BACK = {"models": {"param_specs", "cache_specs"}, "runtime": {"train_state_specs"},
             "optim": {"opt_state_specs"}}


@pytest.mark.parametrize("name,port,ref", [("core", tcore, jcore), ("api", tapi, japi),
                                           ("analysis", tanalysis, janalysis),
                                           ("configs", tconfigs, jconfigs),
                                           ("models", tmodels, jmodels),
                                           ("runtime", truntime, jruntime),
                                           ("optim", toptim, joptim),
                                           ("data", tdata, jdata),
                                           ("ckpt", tckpt, jckpt)])
def test_all_matches_the_reference(name, port, ref):
    held = HELD_BACK.get(name, set())
    assert held <= set(ref.__all__)
    assert set(port.__all__) == (set(ref.__all__) - held) | PORT_ONLY[name]
    for sym in port.__all__:
        assert getattr(port, sym) is not None, sym
    if name == "api":
        from repro_torch.api.index import ShardedIndex

        assert "ShardedIndex" in port.__all__ and port.ShardedIndex is ShardedIndex


def test_the_same_names_are_the_same_objects():
    """A name both namespaces export is one object (no second copy)."""
    from repro_torch.core import families, index, theory

    assert tapi.IndexConfig is tcore.IndexConfig is index.IndexConfig
    assert tapi.DeltaSegment is tcore.DeltaSegment is index.DeltaSegment
    assert tapi.FAMILIES is tcore.FAMILIES is families.FAMILIES
    assert tapi.get_family("theta") is families.THETA
    assert tcore.plan_index is theory.plan_index
    assert tcore.query_index_segmented is index.query_index_segmented


def _fixture(mutable=False):
    rs = np.random.default_rng(4)
    cfg = tapi.IndexConfig(d=6, M=8, K=4, L=6, max_candidates=32,
                           space=tapi.BoundedSpace(0.0, 1.0, 8.0))
    data = rs.uniform(0, 1, (200, 6)).astype(np.float32)
    update = tapi.UpdateSpec(delta_capacity=32 if mutable else 0)
    idx = tapi.Index.build(3, data, cfg, update=update, device="cpu")
    if mutable:
        idx, ids = idx.insert(rs.uniform(0, 1, (20, 6)).astype(np.float32))
        idx = idx.delete(torch.cat([torch.arange(5, dtype=torch.int32), ids[:3]]))
    q = torch.as_tensor(rs.uniform(0, 1, (9, 6)), dtype=torch.float32)
    w = torch.as_tensor(np.abs(rs.normal(size=(9, 6))) + 0.2, dtype=torch.float32)
    return idx, cfg, q, w


def _same(a, b):
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    assert torch.equal(a.n_candidates, b.n_candidates)


@pytest.mark.parametrize("shim", ["query_index", "query_multiprobe"])
def test_query_shims_warn_and_equal_index_query(shim):
    idx, cfg, q, w = _fixture()
    spec = tapi.QuerySpec(k=4, mode="multiprobe" if shim == "query_multiprobe" else "probe")
    with pytest.warns(DeprecationWarning, match=f"repro_torch.core.{shim} is a legacy shim"):
        got = getattr(tcore, shim)(idx.state, q, w, cfg, k=4)
    _same(got, idx.query(q, w, spec))
    # the defining modules stay warning-free
    from repro_torch.core import index, multiprobe

    defining = index.query_index if shim == "query_index" else multiprobe.query_multiprobe
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _same(defining(idx.state, q, w, cfg, k=4), got)


def test_build_index_shim_warns_and_builds_the_same_state():
    idx, cfg, q, w = _fixture()
    data = idx.state.data
    with pytest.warns(DeprecationWarning, match="use repro_torch.api.Index.build"):
        state = tcore.build_index(None, data, cfg, tables=idx.state.tables,
                                  mixers=idx.state.mixers)
    assert torch.equal(state.sorted_keys, idx.state.sorted_keys)
    assert torch.equal(state.perm, idx.state.perm)
    _same(tapi.Index(state=state, config=cfg).query(q, w, tapi.QuerySpec(k=4)),
          idx.query(q, w, tapi.QuerySpec(k=4)))


def test_query_index_segmented_equals_index_query():
    idx, cfg, q, w = _fixture(mutable=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # not a shim: no warning
        got = tcore.query_index_segmented(idx.state, idx.delta, idx.tombstones, q, w, cfg, k=4)
    _same(got, idx.query(q, w, tapi.QuerySpec(k=4)))
    assert not torch.isin(got.ids, torch.tensor([0, 1, 2, 3, 4, 200, 201, 202])).any()


def test_port_code_never_calls_the_warning_shims():
    """The port builds and queries through the defining modules: a whole
    lifecycle raises no DeprecationWarning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        idx, cfg, q, w = _fixture(mutable=True)
        idx.query(q, w, tapi.QuerySpec(k=4, mode="multiprobe"))
        idx.compact().query(q, w, tapi.QuerySpec(k=4))
