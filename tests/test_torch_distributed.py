"""Port parity of the sharded index: ``Index.shard``, ``ShardedIndex`` and
``repro_torch.core.distributed`` (CPU; eight shards on the CPU device).

* Sealed, against the reference's own sharded path: one subprocess (the
  main pytest process must keep seeing one JAX device) gives the reference
  eight host devices, builds its ``Index`` (n=2048, d=12, M=16, K=10, L=16,
  C=128; theta and l2), shards it on a (2, 2, 2) mesh and answers probe,
  multiprobe and exact queries with the hierarchical and the flat merge,
  plus the one-shot ``sharded_query``. The port takes the index's leaves
  (``index_from_numpy``), shards them on eight CPU devices and must give
  equal ids and ``n_candidates`` and dists within rtol/atol 1e-5.
* Mutable, against single-host: the scenario of the reference's
  ``test_mutable_lifecycle_save_load_shard_parity`` (save/load, shard,
  inserts in lockstep, deletes, three modes, compact) held against the
  port's single-host ``Index`` (bit for bit, compact leaf for leaf) and the
  reference's single-host ``Index`` (whose own sharded run of this scenario
  fails on this JAX version, in ``sharded_delta_insert``'s gather).
* Edge cases: every refusal, the early-exit and screen flags dropped as the
  reference drops them, sentinels when k exceeds the candidates, the gids
  ``delete`` ignores, full shards returning -1.

Both parity fixtures run in exact arithmetic: the reference's folded tables
are rounded to multiples of 2**-8, rows and queries to 2**-8 and weights to
2**-4, so every projection sum is exact in f32 whatever its order and the
port's re-hashing of each shard's rows gives the reference's keys.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
from repro.core.transforms import BoundedSpace as JSpace
from repro_torch.core import distributed as tdist
from repro_torch.core.index import build_index, index_from_numpy
from repro_torch.core.transforms import BoundedSpace as TSpace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = ("pod", "data", "model")
CPU8 = ["cpu"] * 8
N, D, M, K, L, C, B, TOPK = 2048, 12, 16, 10, 16, 128, 16, 10
MODES = {
    "probe": dict(k=TOPK),
    "multiprobe": dict(k=TOPK, mode="multiprobe", n_probes=2, max_flips=1),
    "exact": dict(k=TOPK, mode="exact"),
}
# the flags a sharded query drops (each shard runs the monolithic tail)
EARLY_EXIT = dict(k=TOPK, early_exit=True, exit_group=2, exit_slack=0.1)


def _round(x, bits):
    return (np.round(np.asarray(x, np.float64) * 2.0**bits) / 2.0**bits).astype(np.float32)


def _mesh():
    return tdist.make_mesh((2, 2, 2), AXES, devices=CPU8)


_REFERENCE = """
    import dataclasses, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    import repro.core.hash_families as jhf
    from repro.api import Index, IndexConfig, QuerySpec, BoundedSpace
    from repro.core.distributed import sharded_query

    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=jnp.float32):  # traced inside shard_map too
        t = orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jnp.round(t.folded * 256.0) / 256.0,
                                offsets=t.offsets)

    jhf.make_prefix_tables = rounded
    inp = np.load(sys.argv[1])
    modes = {MODES!r}
    mesh = jax.make_mesh((2, 2, 2), {AXES!r})
    out = {{}}

    def keep(prefix, res):
        for f in ("dists", "ids", "n_candidates"):
            out[f"{{prefix}}/{{f}}"] = np.asarray(getattr(res, f))

    for fam in ("theta", "l2"):
        cfg = IndexConfig(d={D}, M={M}, K={K}, L={L}, family=fam, W=4.0,
                          max_candidates={C}, space=BoundedSpace(0., 1., float({M})))
        key = jax.random.PRNGKey(7)
        idx = Index.build(key, inp["data"], cfg)
        s = idx.state
        for name, leaf in (("folded", s.tables.folded), ("offsets", s.tables.offsets),
                           ("mixers", s.mixers), ("sorted_keys", s.sorted_keys),
                           ("perm", s.perm), ("data", s.data), ("levels", s.levels)):
            out[f"{{fam}}/{{name}}"] = np.asarray(leaf)
        hier = idx.shard(mesh)
        for merge, sh in (("hier", hier),
                          ("flat", dataclasses.replace(hier, merge_hierarchical=False))):
            for mode, kw in modes.items():
                if mode == "multiprobe" and fam == "l2":
                    continue  # the l2 family refuses multiprobe
                keep(f"{{fam}}/{{merge}}/{{mode}}", sh.query(inp["q"], inp["w"], QuerySpec(**kw)))
        keep(f"{{fam}}/hier/early_exit",
             hier.query(inp["q"], inp["w"], QuerySpec(**{EARLY_EXIT!r})))
        ds = jax.device_put(jnp.asarray(inp["data"]),
                            NamedSharding(mesh, P(tuple(mesh.axis_names), None)))
        keep(f"{{fam}}/oneshot", sharded_query(key, ds, inp["q"], inp["w"], cfg, mesh, k={TOPK}))
    np.savez(sys.argv[2], **out)
    print("OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's sharded answers, from one subprocess with eight host
    devices, and the inputs they answer."""
    d = tmp_path_factory.mktemp("sharded_reference")
    rs = np.random.default_rng(11)
    inp = {
        "data": _round(rs.uniform(0, 1, (N, D)), 8),
        "q": _round(rs.uniform(0, 1, (B, D)), 8),
        "w": _round(np.abs(rs.normal(size=(B, D))) + 0.2, 4),
    }
    np.savez(d / "inputs.npz", **inp)
    code = textwrap.dedent(_REFERENCE.format(MODES=MODES, EARLY_EXIT=EARLY_EXIT, AXES=AXES, D=D,
                                             M=M, K=K, L=L, C=C, TOPK=TOPK))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run(
        [sys.executable, "-c", code, str(d / "inputs.npz"), str(d / "out.npz")],
        capture_output=True, text=True, env=env, timeout=900,
    )
    assert run.returncode == 0, f"STDOUT:\n{run.stdout}\nSTDERR:\n{run.stderr[-3000:]}"
    return inp, dict(np.load(d / "out.npz"))


def _tcfg(family):
    return tapi.IndexConfig(d=D, M=M, K=K, L=L, family=family, W=4.0, max_candidates=C,
                            space=TSpace(0.0, 1.0, float(M)))


def _port_index(ref, family):
    _, out = ref
    leaves = {k.split("/", 1)[1]: v for k, v in out.items() if k.count("/") == 1
              and k.startswith(family + "/")}
    return tapi.Index(state=index_from_numpy(leaves, _tcfg(family), "cpu"), config=_tcfg(family))


def _same_as_reference(res, out, prefix):
    ids, nc = res.ids.numpy(), res.n_candidates.numpy()
    assert res.ids.dtype == torch.int32 and res.n_candidates.dtype == torch.int32
    assert res.dists.dtype == torch.float32
    assert np.array_equal(ids, out[f"{prefix}/ids"])
    assert np.array_equal(nc, out[f"{prefix}/n_candidates"])
    np.testing.assert_allclose(res.dists.numpy(), out[f"{prefix}/dists"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("merge", ["hier", "flat"])
@pytest.mark.parametrize("family", ["theta", "l2"])
def test_sealed_sharded_query_matches_the_reference(reference, family, merge, mode):
    inp, out = reference
    sharded = _port_index(reference, family).shard(_mesh(), merge_hierarchical=merge == "hier")
    spec = tapi.QuerySpec(**MODES[mode])
    if mode == "multiprobe" and family == "l2":  # refused by both packages
        with pytest.raises(ValueError, match="does not support multiprobe"):
            sharded.query(inp["q"], inp["w"], spec)
        return
    _same_as_reference(sharded.query(inp["q"], inp["w"], spec), out, f"{family}/{merge}/{mode}")


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_sharded_early_exit_matches_the_reference(reference, family):
    """Both packages drop early exit on the sharded path: the answer is the
    reference's, which is its own monolithic probe answer."""
    inp, out = reference
    sharded = _port_index(reference, family).shard(_mesh())
    _same_as_reference(sharded.query(inp["q"], inp["w"], tapi.QuerySpec(**EARLY_EXIT)), out,
                       f"{family}/hier/early_exit")
    for f in ("ids", "dists", "n_candidates"):
        assert np.array_equal(out[f"{family}/hier/early_exit/{f}"], out[f"{family}/hier/probe/{f}"])


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_hierarchical_merge_equals_flat_bit_for_bit(reference, family):
    inp, _ = reference
    idx = _port_index(reference, family)
    for mode, kw in MODES.items():
        if mode == "multiprobe" and family == "l2":
            continue
        a = idx.shard(_mesh()).query(inp["q"], inp["w"], tapi.QuerySpec(**kw))
        b = idx.shard(_mesh(), merge_hierarchical=False).query(inp["q"], inp["w"],
                                                               tapi.QuerySpec(**kw))
        for f in ("dists", "ids", "n_candidates"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (mode, f)


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_one_shot_sharded_query_matches_the_reference(reference, family):
    """The reference's one-shot answer (tables drawn from its key) against
    the port's prebuilt shards over the same tables; and the port's own
    one-shot ``sharded_query`` equals its ``Index.build(...).shard(...)``
    from the same generator state."""
    inp, out = reference
    idx = _port_index(reference, family)
    tables, mixers = idx.state.tables, idx.state.mixers
    shards = tdist.build_local_indexes(tables, mixers, torch.tensor(inp["data"]), _tcfg(family),
                                       _mesh())
    res = tdist.sharded_index_query(shards, torch.tensor(inp["q"]), torch.tensor(inp["w"]),
                                    _tcfg(family), _mesh(), k=TOPK)
    _same_as_reference(res, out, f"{family}/oneshot")

    one = tdist.sharded_query(torch.Generator().manual_seed(5), torch.tensor(inp["data"]),
                              torch.tensor(inp["q"]), torch.tensor(inp["w"]), _tcfg(family),
                              _mesh(), k=TOPK)
    built = tapi.Index.build(torch.Generator().manual_seed(5), inp["data"], _tcfg(family),
                             device="cpu").shard(_mesh()).query(inp["q"], inp["w"],
                                                                tapi.QuerySpec(k=TOPK))
    for f in ("dists", "ids", "n_candidates"):
        assert torch.equal(getattr(one, f), getattr(built, f)), f


def test_shard_zero_and_candidate_counts_are_the_shards_own(reference):
    """The merged ``n_candidates`` is the sum of the shards' own, and shard
    0's answer, globalized, is that of a single-host index over its rows
    built with the parent's tables."""
    inp, _ = reference
    idx = _port_index(reference, "theta")
    sharded = idx.shard(_mesh())
    q, w = torch.tensor(inp["q"]), torch.tensor(inp["w"])
    spec = tapi.QuerySpec(k=TOPK)
    merged = sharded.query(q, w, spec)
    local = tdist.local_results(sharded.index_sharded, q, w, idx.config, spec)
    assert torch.equal(merged.n_candidates,
                       torch.stack([r.n_candidates for r in local]).sum(0, dtype=torch.int32))
    n_local = N // 8
    alone = tapi.Index(state=build_index(None, idx.state.data[:n_local], idx.config,
                                         tables=idx.state.tables, mixers=idx.state.mixers),
                       config=idx.config).query(q, w, spec)
    assert torch.equal(tdist.globalize_ids(local[0].ids, 0, 8, n_local), alone.ids)
    assert torch.equal(local[0].dists, alone.dists)
    for s in range(1, 8):
        g = tdist.globalize_ids(local[s].ids, s, 8, n_local)
        valid = local[s].ids >= 0
        assert torch.equal(g[valid], local[s].ids[valid] + s * n_local)
        assert bool((g[~valid] == -1).all())


# -- the mutable lifecycle against single-host --------------------------------

LN, LD, LK, CAP = 512, 8, 7, 64


@pytest.fixture
def exact_tables(monkeypatch):
    """Round the reference's folded tables to multiples of 2**-8, so every
    projection sum is exact in f32 (the JAX package itself is untouched)."""
    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=None):
        t = orig(key, params) if dtype is None else orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jnp.asarray(_round(t.folded, 8)), offsets=t.offsets)

    monkeypatch.setattr(jhf, "make_prefix_tables", rounded)


def _leaves(jidx):
    s = jidx.state
    return {
        "folded": np.asarray(s.tables.folded), "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers), "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm), "data": np.asarray(s.data), "levels": np.asarray(s.levels),
        "delta_data": np.asarray(jidx.delta.data), "delta_levels": np.asarray(jidx.delta.levels),
        "delta_keys": np.asarray(jidx.delta.keys), "delta_fill": np.asarray(jidx.delta.fill),
        "tombstones": np.asarray(jidx.tombstones),
    }


def _three_agree(j, t, s, label):
    """Reference single-host j, port single-host t, port sharded s: ids and
    counts equal everywhere; the port's two bit-equal; the reference's dists
    within 1e-5."""
    assert torch.equal(t.ids, s.ids) and torch.equal(t.dists, s.dists), label
    assert torch.equal(t.n_candidates, s.n_candidates), label
    assert np.array_equal(np.asarray(j.ids), s.ids.numpy()), label
    assert np.array_equal(np.asarray(j.n_candidates), s.n_candidates.numpy()), label
    np.testing.assert_allclose(s.dists.numpy(), np.asarray(j.dists), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_mutable_lifecycle_save_load_shard_parity(exact_tables, tmp_path, family):
    rs = np.random.default_rng(0)
    data = _round(rs.uniform(0, 1, (LN, LD)), 8)
    extra = _round(rs.uniform(0, 1, (37, LD)), 8)
    q = _round(rs.uniform(0, 1, (5, LD)), 8)
    w = _round(np.abs(rs.normal(size=(5, LD))) + 0.2, 4)
    kw = dict(d=LD, M=8, K=6, L=10, family=family, W=4.0, max_candidates=LN + 64)
    jcfg = japi.IndexConfig(space=JSpace(0.0, 1.0, 8.0), **kw)
    tcfg = tapi.IndexConfig(space=TSpace(0.0, 1.0, 8.0), **kw)

    jloc = japi.Index.build(jax.random.PRNGKey(9), data, jcfg,
                            update=japi.UpdateSpec(delta_capacity=CAP))
    jloc, ids = jloc.insert(extra)
    jloc = jloc.delete(jnp.asarray([3, 77, int(ids[4])], jnp.int32))
    tloc = tapi.Index.from_numpy(_leaves(jloc), tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                                 device="cpu")
    restored = tapi.Index.load(tloc.save(tmp_path / "idx"), device="cpu")
    sharded = restored.shard(_mesh())  # replays the delta, then the tombstones
    assert sharded.delta_fill == 37 and sharded.n == LN and sharded.n_shards == 8
    assert [d.fill for d in sharded.delta_sharded] == [5, 5, 5, 5, 5, 4, 4, 4]
    spec = tapi.QuerySpec(k=LK)
    _three_agree(jloc.query(q, w, japi.QuerySpec(k=LK)), tloc.query(q, w, spec),
                 sharded.query(q, w, spec), "after shard")

    # the lifecycle goes on sharded, in lockstep with single-host
    jloc2, ids_j = jloc.insert(extra[:11])
    tloc2, ids_t = tloc.insert(extra[:11])
    sharded2, ids_s = sharded.insert(extra[:11])
    assert np.array_equal(np.asarray(ids_j), ids_s.numpy()) and torch.equal(ids_t, ids_s)
    dels = [int(ids_t[0]), 42]
    jloc2 = jloc2.delete(jnp.asarray(dels, jnp.int32))
    tloc2, sharded2 = tloc2.delete(torch.tensor(dels)), sharded2.delete(torch.tensor(dels))
    modes = [("probe", {}), ("multiprobe", dict(n_probes=8, max_flips=3)), ("exact", {})]
    for mode, extra_kw in modes[:: 2 if family == "l2" else 1]:  # l2 refuses multiprobe
        a = jloc2.query(q, w, japi.QuerySpec(k=LK, mode=mode, **extra_kw))
        b = tloc2.query(q, w, tapi.QuerySpec(k=LK, mode=mode, **extra_kw))
        c = sharded2.query(q, w, tapi.QuerySpec(k=LK, mode=mode, **extra_kw))
        _three_agree(a, b, c, mode)
        assert not np.isin(dels, c.ids.numpy()).any()

    # sharded compact == single-host compact, leaf for leaf
    ja, ta, sa = jloc2.compact(), tloc2.compact(), sharded2.compact()
    assert sa.update == ta.update and sa.build_key is restored.build_key
    for f in ("sorted_keys", "perm", "data", "levels", "mixers"):
        assert torch.equal(getattr(ta.state, f), getattr(sa.state, f)), f
        assert np.array_equal(np.asarray(getattr(ja.state, f)), getattr(sa.state, f).numpy()), f
    assert torch.equal(ta.state.tables.folded, sa.state.tables.folded)
    assert torch.equal(ta.state.tables.offsets, sa.state.tables.offsets)
    assert sa.state.scales is None and not sa.delta_fill


# -- edge cases ----------------------------------------------------------------


def _small(mutable=False, n=64, cap=16, storage="f32", **cfg_kw):
    rs = np.random.default_rng(3)
    kw = dict(d=4, M=8, K=3, L=4, max_candidates=16, space=TSpace(0.0, 1.0, 8.0),
              storage=storage) | cfg_kw
    update = tapi.UpdateSpec(delta_capacity=cap if mutable else 0)
    data = rs.uniform(0, 1, (n, 4)).astype(np.float32)
    return tapi.Index.build(0, data, tapi.IndexConfig(**kw), update=update, device="cpu")


def _four():
    return tdist.make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)


@pytest.mark.parametrize("case", [
    "int8", "bf16", "capacity", "rows", "not_a_mesh", "unplanned", "sealed_insert",
    "sealed_delete", "sealed_compact", "bad_rows", "bad_query", "probe_reach", "bad_spec",
])
def test_refusals(case):
    q, w = np.full((2, 4), 0.5, np.float32), np.ones((2, 4), np.float32)
    if case in ("int8", "bf16"):
        with pytest.raises(ValueError, match="storage='f32' only.*serving.chaos.ShardSet"):
            _small(storage=case).shard(_four())
    elif case == "capacity":
        with pytest.raises(ValueError, match="delta_capacity=18 must be a multiple of the mesh"):
            _small(mutable=True, cap=18).shard(_four())
    elif case == "rows":
        with pytest.raises(ValueError, match="cannot be split into 4 equal shards"):
            _small(n=66).shard(_four())
    elif case == "not_a_mesh":
        with pytest.raises(TypeError, match="takes a repro_torch.core.distributed.Mesh"):
            _small().shard(("data",))
    elif case == "unplanned":
        with pytest.raises(ValueError, match="call index.plan\\(quality\\)"):
            _small().shard(_four()).query(q, w, tapi.QualitySpec(k=2))
    elif case.startswith("sealed_"):
        sharded, op = _small().shard(_four()), case.split("_")[1]
        args = {"insert": (q,), "delete": ([0],), "compact": ()}[op]
        with pytest.raises(ValueError, match=f"ShardedIndex.{op}\\(\\) requires a mutable"):
            getattr(sharded, op)(*args)
    elif case == "bad_rows":
        with pytest.raises(ValueError, match="insert rows must be"):
            _small(mutable=True).shard(_four()).insert(np.zeros((2, 3), np.float32))
    elif case == "bad_query":
        with pytest.raises(ValueError, match="non-finite"):
            _small().shard(_four()).query(np.full((2, 4), np.nan), w)
    elif case == "probe_reach":
        with pytest.raises(ValueError, match="distinct probe keys"):
            _small().shard(_four()).query(q, w, tapi.QuerySpec(k=2, mode="multiprobe",
                                                               n_probes=64, max_flips=1))
    else:
        with pytest.raises(TypeError, match="spec must be"):
            _small().shard(_four()).query(q, w, "probe")


@pytest.mark.parametrize("case", ["no_cuda", "count", "axes", "names"])
def test_make_mesh_refusals(case):
    """``make_mesh()`` takes the CUDA cards by default and never the CPU:
    without enough of them it raises, showing ``devices=``."""
    if case == "no_cuda":
        if torch.cuda.is_available() and torch.cuda.device_count() == 8:
            pytest.skip("this host has eight cards: the mesh is valid")
        with pytest.raises(ValueError, match=r"pass devices=.*\[torch.device\('cuda', 0\)\] \* 8"):
            tdist.make_mesh((2, 2, 2), AXES)
    elif case == "count":
        with pytest.raises(ValueError, match="needs 8 devices, got 4"):
            tdist.make_mesh((2, 2, 2), AXES, devices=["cpu"] * 4)
    elif case == "axes":
        with pytest.raises(ValueError, match="one name per axis"):
            tdist.Mesh(np.array([torch.device("cpu")] * 4, dtype=object), ("a", "b"))
    else:
        with pytest.raises(ValueError, match="distinct"):
            tdist.make_mesh((2, 2), ("a", "a"), devices=["cpu"] * 4)


def test_mesh_layout_is_row_major():
    mesh = _mesh()
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert mesh.axis_names == AXES and mesh.devices.shape == (2, 2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    idx = _small(n=64)
    sharded = idx.shard(mesh)
    for s, state in enumerate(sharded.index_sharded):  # shard s holds rows [8s, 8s + 8)
        assert torch.equal(state.data, idx.state.data[8 * s: 8 * s + 8])


@pytest.mark.parametrize("flag", ["early_exit", "screen_alpha"])
def test_dropped_flags_run_the_monolithic_tail(flag):
    """Each shard gets only k, mode, n_probes, max_flips and impl: a sharded
    query with early exit or a screen answers as the plain one, bit for bit
    (the single-host index would stream)."""
    idx = _small(n=256, L=8)
    rs = np.random.default_rng(4)
    q = torch.tensor(rs.uniform(0, 1, (6, 4)), dtype=torch.float32)
    w = torch.ones((6, 4))
    kw = dict(early_exit=True, exit_group=2, exit_slack=0.1) if flag == "early_exit" else dict(
        screen_alpha=2.0)
    sharded = idx.shard(_four())
    for mode in ("probe", "multiprobe"):
        a = sharded.query(q, w, tapi.QuerySpec(k=3, mode=mode, **kw))
        b = sharded.query(q, w, tapi.QuerySpec(k=3, mode=mode))
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
        assert not hasattr(a, "tables_probed")
    if flag == "early_exit":
        single = idx.query(q, w, tapi.QuerySpec(k=3, **kw))
        assert single.tables_probed is not None


@pytest.mark.parametrize("mode", ["probe", "exact"])
def test_sentinels_when_k_exceeds_the_candidates(mode):
    """k above every shard's candidates (and, in exact mode, above n): the
    tail slots are -1 exactly where the dists are +inf, after the real rows."""
    idx = _small(n=32, max_candidates=4)
    sharded = idx.shard(_four())
    q = torch.full((3, 4), 0.5)
    res = sharded.query(q, torch.ones((3, 4)), tapi.QuerySpec(k=40, mode=mode))
    assert tuple(res.ids.shape) == (3, 40)
    assert torch.equal(torch.isinf(res.dists), res.ids < 0)
    n_valid = (res.ids >= 0).sum(dim=1)
    if mode == "exact":
        assert bool((n_valid == 32).all()) and bool((res.n_candidates == 32).all())
    else:
        assert bool((n_valid == res.n_candidates).all()) and bool((n_valid < 40).all())
    for row, nv in zip(res.ids, n_valid.tolist()):
        assert bool((row[:nv] >= 0).all()) and bool((row[nv:] == -1).all())


def test_delete_ignores_unknown_gids():
    """Negative, out-of-range and unassigned delta gids change no
    tombstone, as the single-host ``delete`` ignores them."""
    idx = _small(mutable=True, n=64, cap=16)
    idx, ids = idx.insert(np.random.default_rng(1).uniform(0, 1, (5, 4)))
    sharded = idx.shard(_four())
    unknown = [-1, -7, 64 + 5, 64 + 6, 64 + 15, 64 + 16, 10**6]  # fill is 5 of 16
    after = sharded.delete(torch.tensor(unknown))
    for a, b in zip(after.tombstones_sharded, sharded.tombstones_sharded):
        assert torch.equal(a, b)
    assert not bool(idx.delete(unknown).tombstones.any())
    known = after.delete(torch.tensor([0, 63, 64, 68]))  # main 0 and 63, inserts 0 and 4
    marked = [torch.nonzero(t).flatten().tolist() for t in known.tombstones_sharded]
    # shard 0 holds main rows 0-15 and delta slots 16-19 (inserts 0, 4, ...)
    assert marked == [[0, 16, 17], [], [], [15]]


def test_full_shards_return_minus_one():
    """Each shard owns cap / S slots; inserts past them return -1, as the
    single-host index's past its capacity, and the next insert too."""
    idx = _small(mutable=True, n=64, cap=8)
    sharded = idx.shard(_four())
    rows = np.random.default_rng(2).uniform(0, 1, (11, 4)).astype(np.float32)
    single, want = idx.insert(rows)
    sharded, got = sharded.insert(rows)
    assert torch.equal(got, want) and got.tolist() == list(range(64, 72)) + [-1] * 3
    assert [d.fill for d in sharded.delta_sharded] == [2, 2, 2, 2] and sharded.needs_compact
    _, more = sharded.insert(rows[:2])
    assert more.tolist() == [-1, -1]
    q, w = torch.tensor(rows[:4]), torch.ones((4, 4))
    a = single.query(q, w, tapi.QuerySpec(k=3, mode="exact"))
    b = sharded.query(q, w, tapi.QuerySpec(k=3, mode="exact"))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def test_partial_delta_replays_from_position_zero():
    """A parent with a partly filled delta: the replay starts at e=0, the
    phase of the next insert is the total fill, and the ids go on as the
    single-host index's."""
    idx = _small(mutable=True, n=64, cap=16)
    rs = np.random.default_rng(6)
    idx, first = idx.insert(rs.uniform(0, 1, (3, 4)))
    sharded = idx.shard(_four())
    assert [d.fill for d in sharded.delta_sharded] == [1, 1, 1, 0]
    rows = rs.uniform(0, 1, (6, 4))
    single, want = idx.insert(rows)
    sharded, got = sharded.insert(rows)
    assert torch.equal(got, want) and got.tolist() == list(range(67, 73))
    assert [d.fill for d in sharded.delta_sharded] == [3, 2, 2, 2]
    assert sharded.delta_fill == single.delta_fill == 9
    # the advisory is per shard: shard 0 holds 3 of its 4 slots, the index 9 of 16
    assert sharded.needs_compact and not single.needs_compact
