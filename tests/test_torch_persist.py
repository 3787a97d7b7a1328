"""Port parity of persistence (CPU): ``Index.save``/``Index.load`` in the
reference's directory format, both ways.

* Reference directory -> port: indexes the JAX package built (f32, int8,
  bf16; sealed, and mutable with a filled delta and tombstones; one plan
  memo entry and a tuning stamp) load into ``repro_torch`` leaf for leaf
  (bf16 by bits) and answer as the reference answers — probe, multiprobe,
  exact, screened, two-segment — and so do ``insert``, ``delete`` and
  ``compact`` after the load. Versions 1–4, made by rewriting
  ``index.json``, load as the reference loads them.
* Port directory -> reference: the JAX package loads what the port wrote,
  from a port-built index and from a reference-loaded one, and answers as
  the port does; the re-saved payload of a reference-loaded index equals
  the reference's own byte for byte, under zstd and under the zlib
  fallback.
* Damage: the scenarios of tests/test_index_persistence.py, on directories
  that either package wrote, raise the reference's error class in both.
* The msgpack subset packs as ``msgpack.packb(use_bin_type=True)`` does.

Bar: leaves and ids exactly, ``n_candidates`` exactly, dists within
rtol/atol 1e-5 (tests/test_kernels_topk.py). The reference's folded tables
are rounded to multiples of 2**-8 and the rows, queries and weights to 2**-8
and 2**-4, so every projection sum is exact in f32 and the port's own
inserts hash as the reference's do (tests/test_torch_lifecycle.py's
fixture; the JAX package itself is untouched).
"""

import dataclasses
import glob
import json
import os
import shutil
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import zstandard

import hypothesis
import hypothesis.strategies as st
import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
from repro import ckpt as jckpt
from repro.api import persist as jpersist
from repro.core.transforms import BoundedSpace as JSpace
from repro_torch import ckpt as tckpt
from repro_torch.api import persist as tpersist
from repro_torch.ckpt import _msgpack
from repro_torch.core.transforms import BoundedSpace as TSpace

N, D, M, K, L, C, CAP, B, TOPK = 2000, 12, 16, 8, 8, 32, 256, 32, 10
STORAGES = ("f32", "int8", "bf16")
KINDS = ("sealed", "mutable")
QUALITY = japi.QualitySpec(k=TOPK, recall_target=0.9)
PLANNED = japi.PlannedSpec(k=TOPK, mode="multiprobe", n_probes=4, max_flips=2,
                           max_candidates=C, predicted_recall=0.93, predicted_success=0.97,
                           expected_candidates=151.5, expected_tables=16.0, provenance="prior")
TUNING = {"format": "repro.tuner.pareto", "version": 1, "space_id": "0a1b2c3d", "n_trials": 24,
          "k": TOPK}


def _round(x, bits):
    return (np.round(np.asarray(x, np.float64) * 2.0**bits) / 2.0**bits).astype(np.float32)


def _configs(storage, **over):
    kw = dict(d=D, M=M, K=K, L=L, family="theta", max_candidates=C, storage=storage) | over
    return (japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw),
            tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw))


def _problem(seed):
    rs = np.random.default_rng(seed)
    data = _round(rs.uniform(0, 1, (N, D)), 8)
    extra = _round(rs.uniform(0, 1, (CAP, D)), 8)
    q = _round(rs.uniform(0, 1, (B, D)), 8)
    q[:8] = extra[:8]  # these sit on inserted rows: the delta answers them
    w = _round(np.abs(rs.normal(size=(B, D))) + 0.1, 4)
    return data, extra, q, w


@pytest.fixture(scope="module")
def exact_tables():
    """Round the reference's folded tables to multiples of 2**-8 while this
    module's reference indexes are built."""
    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=None):
        t = orig(key, params) if dtype is None else orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jnp.asarray(_round(t.folded, 8)), offsets=t.offsets)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhf, "make_prefix_tables", rounded)
        yield


def _reference_index(storage, kind, seed=5):
    """The reference's index: built, and for "mutable" 150 rows inserted,
    34 main rows and 8 delta rows deleted; with a plan and a tuning stamp."""
    jcfg, _ = _configs(storage)
    data, extra, _, _ = _problem(seed)
    cap = CAP if kind == "mutable" else 0
    jidx = japi.Index.build(jax.random.PRNGKey(seed), data, jcfg,
                            update=japi.UpdateSpec(delta_capacity=cap))
    if kind == "mutable":
        jidx, ids = jidx.insert(extra[:150])
        jidx = jidx.delete(jnp.arange(0, 100, 3, dtype=jnp.int32))
        jidx = jidx.delete(ids[10:150:20])
    jidx.plans = {QUALITY: PLANNED}
    jidx.tuning = dict(TUNING)
    return jidx


@pytest.fixture(scope="module")
def refs(exact_tables, tmp_path_factory):
    """(storage, kind) -> (reference index, the directory it saved)."""
    cache = {}

    def get(storage, kind):
        if (storage, kind) not in cache:
            jidx = _reference_index(storage, kind)
            d = str(tmp_path_factory.mktemp(f"ref_{storage}_{kind}"))
            jidx.save(d)
            cache[(storage, kind)] = (jidx, d)
        return cache[(storage, kind)]

    return get


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _t(x):
    """A port tensor as numpy (bf16 as its bit pattern)."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16)
    return x.numpy()


def _reference_leaves(jidx) -> dict:
    s = jidx.state
    out = {"build_key": np.asarray(jidx.build_key)}
    for i, f in enumerate(("data", "levels", "keys")):
        out[f"delta/{i}"] = _bits(getattr(jidx.delta, f))
    out["delta/3"] = np.asarray(jidx.delta.fill)
    out["state/0/0"], out["state/0/1"] = np.asarray(s.tables.folded), np.asarray(s.tables.offsets)
    for i, f in enumerate(("mixers", "sorted_keys", "perm", "data", "levels"), start=1):
        out[f"state/{i}"] = _bits(getattr(s, f))
    if s.scales is not None:
        out["state/6"] = np.asarray(s.scales)
    out["tombstones"] = np.asarray(jidx.tombstones)
    return out


def _port_leaves(tidx) -> dict:
    s = tidx.state
    out = {"build_key": tidx.build_key}
    for i, f in enumerate(("data", "levels", "keys")):
        out[f"delta/{i}"] = _t(getattr(tidx.delta, f))
    out["delta/3"] = np.asarray(tidx.delta.fill, np.int32)
    out["state/0/0"], out["state/0/1"] = _t(s.tables.folded), _t(s.tables.offsets)
    for i, f in enumerate(("mixers", "sorted_keys", "perm", "data", "levels"), start=1):
        out[f"state/{i}"] = _t(getattr(s, f))
    if s.scales is not None:
        out["state/6"] = _t(s.scales)
    out["tombstones"] = _t(tidx.tombstones)
    return out


def _assert_leaves_equal(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert np.array_equal(got[k], want[k]), k


def _assert_same_answer(tres, jres):
    assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    assert np.array_equal(tres.n_candidates.numpy(), np.asarray(jres.n_candidates))
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=1e-5, atol=1e-5)


def _payload(directory) -> bytes:
    (f,) = glob.glob(os.path.join(directory, "step_*", "shard_*"))
    blob = open(f, "rb").read()
    if f.endswith(".zst"):
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _meta(directory) -> dict:
    return json.load(open(os.path.join(directory, "index.json")))


def _write_meta(directory, meta):
    with open(os.path.join(directory, "index.json"), "w") as fh:
        json.dump(meta, fh)


# --- reference directory -> port ---------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", STORAGES)
def test_reference_directory_loads_leaf_for_leaf(refs, storage, kind):
    jidx, d = refs(storage, kind)
    tidx = tapi.Index.load(d, device="cpu")
    _assert_leaves_equal(_port_leaves(tidx), _reference_leaves(jidx))
    assert tidx.config == _configs(storage)[1]
    assert tidx.update == tapi.UpdateSpec(delta_capacity=CAP if kind == "mutable" else 0)
    assert isinstance(tidx.delta.fill, int) and tidx.delta_fill == int(jidx.delta.fill)
    assert tidx.n_live == jidx.n_live and tidx.table_bytes == jidx.table_bytes
    assert tpersist.plans_to_list(tidx.plans) == jpersist.plans_to_list(jidx.plans)
    assert tidx.tuning == TUNING
    assert tidx.state.tables.tiled is None  # the kernel's relayout exists on the card only


QUERY_CASES = [
    (storage, kind, mode, alpha)
    for storage in STORAGES
    for kind in KINDS
    for mode, alpha in (("probe", 0.0), ("multiprobe", 0.0), ("exact", 0.0), ("probe", 2.0))
    if not (alpha and storage == "f32")
]


@pytest.mark.parametrize("storage,kind,mode,alpha", QUERY_CASES)
def test_reference_directory_answers_as_reference(refs, storage, kind, mode, alpha):
    """Probe, multiprobe, exact and screened queries; a mutable index runs
    the two-segment query."""
    jidx, d = refs(storage, kind)
    tidx = tapi.Index.load(d, device="cpu")
    _, _, q, w = _problem(5)
    spec = dict(k=TOPK, mode=mode, screen_alpha=alpha)
    jres = japi.Index.load(d).query(q, w, japi.QuerySpec(**spec))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec))
    _assert_same_answer(tres, jres)
    _assert_same_answer(tres, jidx.query(q, w, japi.QuerySpec(**spec)))
    if kind == "mutable" and mode != "exact":
        assert (tres.ids.numpy() >= N).any(), "degenerate test: no delta row in any result"


@pytest.mark.parametrize("storage", STORAGES)
def test_lifecycle_after_load_matches_reference(refs, storage):
    """insert, delete and compact on the loaded index: the port's and the
    reference's (each on its own load) stay equal, state and answers."""
    _, d = refs(storage, "mutable")
    jidx, tidx = japi.Index.load(d), tapi.Index.load(d, device="cpu")
    _, extra, q, w = _problem(5)
    jidx, jids = jidx.insert(extra[150:200])
    tidx, tids = tidx.insert(torch.from_numpy(extra[150:200]))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    gone = np.concatenate([np.arange(1, 60, 7), np.asarray(jids)[::9]]).astype(np.int32)
    jidx, tidx = jidx.delete(jnp.asarray(gone)), tidx.delete(torch.from_numpy(gone))
    _assert_leaves_equal(_port_leaves(tidx), _reference_leaves(jidx))
    tq, tw = torch.from_numpy(q), torch.from_numpy(w)
    _assert_same_answer(tidx.query(tq, tw, tapi.QuerySpec(k=TOPK)),
                        jidx.query(q, w, japi.QuerySpec(k=TOPK)))
    jc, tc = jidx.compact(), tidx.compact()
    _assert_leaves_equal(_port_leaves(tc), _reference_leaves(jc))
    for mode in ("probe", "exact"):
        _assert_same_answer(tc.query(tq, tw, tapi.QuerySpec(k=TOPK, mode=mode)),
                            jc.query(q, w, japi.QuerySpec(k=TOPK, mode=mode)))


def test_index_fields_follow_the_reference_lifecycle(refs):
    """insert and delete keep build_key, plans and tuning; compact keeps
    build_key and drops the other two (as the reference does)."""
    _, d = refs("f32", "mutable")
    jidx, tidx = japi.Index.load(d), tapi.Index.load(d, device="cpu")
    _, extra, _, _ = _problem(5)
    for j, t in ((jidx.insert(extra[:3])[0], tidx.insert(torch.from_numpy(extra[:3]))[0]),
                 (jidx.delete(jnp.arange(2)), tidx.delete(torch.arange(2)))):
        assert np.array_equal(t.build_key, np.asarray(j.build_key))
        assert tpersist.plans_to_list(t.plans) == jpersist.plans_to_list(j.plans)
        assert t.plans is tidx.plans and t.tuning == j.tuning == TUNING
    jc, tc = jidx.compact(), tidx.compact()
    assert np.array_equal(tc.build_key, np.asarray(jc.build_key))
    assert tc.plans == {} and jc.plans == {} and tc.tuning is None and jc.tuning is None


def test_plans_and_tuning_round_trip(refs, tmp_path):
    """The plan memo and tuning stamp go reference -> port -> reference
    unchanged."""
    jidx, d = refs("int8", "mutable")
    tidx = tapi.Index.load(d, device="cpu")
    assert tpersist.plans_to_list(tidx.plans) == _meta(d)["plans"] and len(tidx.plans) == 1
    tidx.save(tmp_path / "again")
    back = japi.Index.load(str(tmp_path / "again"))
    assert back.plans == {QUALITY: PLANNED} and back.tuning == TUNING
    assert _meta(str(tmp_path / "again")) == _meta(d)


def _typed(plans):
    """A plan memo as {quality fields: planned fields}, whichever package's."""
    return {tuple(dataclasses.asdict(q).items()): dataclasses.asdict(p) for q, p in plans.items()}


@pytest.mark.parametrize("storage", STORAGES)
def test_reference_plans_load_typed(refs, storage):
    """The reference's plan memo loads as typed ``QualitySpec ->
    PlannedSpec`` entries equal to the reference's."""
    jidx, d = refs(storage, "sealed")
    tidx = tapi.Index.load(d, device="cpu")
    (tq, tplan), = tidx.plans.items()
    assert isinstance(tq, tapi.QualitySpec) and isinstance(tplan, tapi.PlannedSpec)
    assert _typed(tidx.plans) == _typed(jidx.plans) == _typed({QUALITY: PLANNED})
    assert tidx.plan(tq) is tplan  # the memo answers without a calibration
    assert tidx.tuning == TUNING and tidx.plan_times == {} and tidx.ladders == {}


@pytest.mark.parametrize("kind", KINDS)
def test_port_plans_load_typed_in_reference(tmp_path, kind):
    """A port-built index with a plan memo and a tuning stamp: the reference
    loads equal PlannedSpecs, and both packages' manifests are byte-equal
    after a reload and a save on each side."""
    tidx = _port_index("f32", kind, n=600)
    tq = tapi.QualitySpec(**dataclasses.asdict(QUALITY))
    tidx.plans[tq] = tapi.PlannedSpec(**dataclasses.asdict(PLANNED))
    tidx.plans[dataclasses.replace(tq, seed=3, latency_budget_ms=2.5)] = tapi.PlannedSpec(
        k=TOPK, mode="probe", max_candidates=16, predicted_recall=0.5, predicted_success=0.25,
        expected_candidates=10.0, early_exit=True, exit_group=4, exit_slack=0.1,
        expected_tables=6.5)
    tidx.tuning = dict(TUNING)
    d = tidx.save(tmp_path / "port")
    jidx = japi.Index.load(d)
    assert _typed(jidx.plans) == _typed(tidx.plans) and jidx.tuning == TUNING
    assert all(isinstance(p, japi.PlannedSpec) for p in jidx.plans.values())
    jidx.save(str(tmp_path / "ref_again"))
    tapi.Index.load(d, device="cpu").save(tmp_path / "port_again")
    manifest = (tmp_path / "port" / "index.json").read_bytes()
    assert (tmp_path / "ref_again" / "index.json").read_bytes() == manifest
    assert (tmp_path / "port_again" / "index.json").read_bytes() == manifest
    assert tapi.Index.load(tmp_path / "port_again", device="cpu").plans == tidx.plans


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", STORAGES)
def test_resaved_manifest_with_plans_is_byte_equal(refs, tmp_path, storage, kind):
    """A reference directory with a plan memo and a tuning stamp, loaded and
    saved by the port: ``index.json`` equals the reference's byte for byte."""
    _, d = refs(storage, kind)
    out = tapi.Index.load(d, device="cpu").save(tmp_path / "resaved")
    assert open(os.path.join(out, "index.json"), "rb").read() == open(
        os.path.join(d, "index.json"), "rb").read()


def _as_version(d, version, keep_storage):
    """Rewrite ``index.json`` as a directory of an earlier format version
    (the keys that version did not write are dropped)."""
    meta = _meta(d)
    meta["version"] = version
    if version < 5:
        meta.pop("codec", None)
        if not keep_storage:
            meta["config"].pop("storage", None)
    if version < 4:
        meta.pop("tuning", None)
    if version < 3:
        meta.pop("plans", None)
    if version < 2:
        for key in ("update", "segments", "tombstone_count"):
            meta.pop(key, None)
    _write_meta(d, meta)


@pytest.mark.parametrize("version", [1, 2, 3, 4])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_old_versions_load_as_the_reference_loads_them(refs, tmp_path, storage, version):
    """An f32 directory loses its ``storage`` key too (pre-v5 layout); an
    int8 one keeps it (the reference reads it whatever the version)."""
    _, src = refs(storage, "mutable")
    d = str(tmp_path / f"v{version}")
    shutil.copytree(src, d)
    _as_version(d, version, keep_storage=storage != "f32")
    jidx, tidx = japi.Index.load(d), tapi.Index.load(d, device="cpu")
    assert tidx.config.storage == jidx.config.storage == storage
    assert tidx.update == tapi.UpdateSpec(**dataclasses.asdict(jidx.update))
    assert tidx.mutable == jidx.mutable == (version >= 2)
    assert tidx.tuning == jidx.tuning == (TUNING if version >= 4 else None)
    assert tpersist.plans_to_list(tidx.plans) == jpersist.plans_to_list(jidx.plans)
    assert len(tidx.plans) == (1 if version >= 3 else 0)
    _assert_leaves_equal(_port_leaves(tidx), _reference_leaves(jidx))
    _, _, q, w = _problem(5)
    _assert_same_answer(tidx.query(torch.from_numpy(q), torch.from_numpy(w),
                                   tapi.QuerySpec(k=TOPK)),
                        jidx.query(q, w, japi.QuerySpec(k=TOPK)))


# --- port directory -> reference ---------------------------------------------


def _port_index(storage, kind, seed=9, n=N):
    """An index the port built itself (torch RNG tables), mutated by the
    port for "mutable"."""
    _, tcfg = _configs(storage)
    data, extra, _, _ = _problem(seed)
    cap = CAP if kind == "mutable" else 0
    tidx = tapi.Index.build(seed, data[:n], tcfg, update=tapi.UpdateSpec(delta_capacity=cap),
                            device="cpu")
    if kind == "mutable":
        tidx, ids = tidx.insert(torch.from_numpy(extra[:120]))
        tidx = tidx.delete(torch.cat([torch.arange(0, 90, 4, dtype=torch.int32), ids[::11]]))
    return tidx


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", STORAGES)
def test_port_built_directory_loads_in_reference(tmp_path, storage, kind):
    tidx = _port_index(storage, kind)
    assert tidx.build_key is None
    d = tidx.save(tmp_path / "port")
    assert d == str(tmp_path / "port")
    jidx = japi.Index.load(d)
    assert np.array_equal(np.asarray(jidx.build_key), tpersist.PORT_BUILT_KEY)
    again = tapi.Index.load(d, device="cpu")
    assert np.array_equal(again.build_key, tpersist.PORT_BUILT_KEY)
    want = _port_leaves(tidx) | {"build_key": tpersist.PORT_BUILT_KEY}
    _assert_leaves_equal(_reference_leaves(jidx), want)
    _assert_leaves_equal(_port_leaves(again), want)
    _, _, q, w = _problem(9)
    screened = [] if storage == "f32" else [("probe", 2.0)]
    for mode, alpha in [("probe", 0.0), ("exact", 0.0)] + screened:
        spec = dict(k=TOPK, mode=mode, screen_alpha=alpha)
        tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec))
        _assert_same_answer(tres, jidx.query(q, w, japi.QuerySpec(**spec)))
        assert torch.equal(again.query(torch.from_numpy(q), torch.from_numpy(w),
                                       tapi.QuerySpec(**spec)).ids, tres.ids)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("storage", STORAGES)
def test_resaved_payload_equals_the_reference_bytes(refs, tmp_path, storage, kind):
    """A reference directory loaded by the port and saved again: the
    decompressed payload equals the reference's byte for byte, the manifest
    equals it key for key, and the reference loads it."""
    jidx, d = refs(storage, kind)
    out = tapi.Index.load(d, device="cpu").save(tmp_path / "resaved")
    assert glob.glob(os.path.join(out, "step_000000000", "shard_0.msgpack.zst"))
    assert _payload(out) == _payload(d)
    assert _meta(out) == _meta(d)
    back = japi.Index.load(out)
    _assert_leaves_equal(_reference_leaves(back), _reference_leaves(jidx))


@pytest.mark.parametrize("storage", STORAGES)
def test_zlib_fallback_is_read_by_the_reference(refs, tmp_path, monkeypatch, storage):
    """Without zstandard the port writes zlib to ``.msgpack.zlib``; the
    reference reads it, the payload is the reference's, and a zstd file
    read without zstandard raises the reference's ModuleNotFoundError."""
    jidx, d = refs(storage, "mutable")
    monkeypatch.setitem(sys.modules, "zstandard", None)  # `import zstandard` fails
    with pytest.raises(ModuleNotFoundError, match="written with zstandard, which is not installed"):
        tapi.Index.load(d, device="cpu")
    monkeypatch.delitem(sys.modules, "zstandard")
    tidx = tapi.Index.load(d, device="cpu")
    monkeypatch.setitem(sys.modules, "zstandard", None)
    out = tidx.save(tmp_path / "zlib")
    (f,) = glob.glob(os.path.join(out, "step_*", "shard_*"))
    assert f.endswith("shard_0.msgpack.zlib") and open(f, "rb").read(4) != b"\x28\xb5\x2f\xfd"
    assert _payload(out) == _payload(d)
    again = tapi.Index.load(out, device="cpu")  # zstandard still blocked
    _assert_leaves_equal(_port_leaves(again), _reference_leaves(jidx))
    monkeypatch.delitem(sys.modules, "zstandard")
    back = japi.Index.load(out)
    _assert_leaves_equal(_reference_leaves(back), _reference_leaves(jidx))
    _, _, q, w = _problem(5)
    _assert_same_answer(again.query(torch.from_numpy(q), torch.from_numpy(w),
                                    tapi.QuerySpec(k=TOPK)),
                        back.query(q, w, japi.QuerySpec(k=TOPK)))


def test_restore_names_a_missing_leaf(refs):
    _, d = refs("f32", "sealed")
    with pytest.raises(KeyError, match="checkpoint missing leaf state/6"):
        tckpt.restore_checkpoint(d, 0, ["build_key", "state/6"])
    got = tckpt.restore_checkpoint(d, 0, ["delta/3", "state/1"])
    assert got["delta/3"].shape == () and got["state/1"].flags.writeable


# --- damage: each scenario raises the reference's error class ----------------


def _small_dir(tmp_path, writer, storage, name):
    """tests/test_index_persistence.py's small mutable index (n=256, d=8,
    L=4, a delta of 32), saved by ``writer``."""
    kw = dict(d=8, M=16, K=6, L=4, family="theta", max_candidates=32, storage=storage)
    data = np.random.default_rng(17).uniform(0, 1, (256, 8)).astype(np.float32)
    d = str(tmp_path / name)
    if writer == "reference":
        cfg = japi.IndexConfig(space=JSpace(0.0, 1.0, 16.0), **kw)
        japi.Index.build(jax.random.PRNGKey(17), data, cfg,
                         update=japi.UpdateSpec(delta_capacity=32)).save(d)
    else:
        cfg = tapi.IndexConfig(space=TSpace(0.0, 1.0, 16.0), **kw)
        tapi.Index.build(17, data, cfg, update=tapi.UpdateSpec(delta_capacity=32),
                         device="cpu").save(d)
    return d


def _shard(d):
    (f,) = glob.glob(os.path.join(d, "step_*", "shard_*"))
    return f


def _truncate(d):
    f = _shard(d)
    blob = open(f, "rb").read()
    open(f, "wb").write(blob[: len(blob) // 2])


def _flip(frac):
    def damage(d):
        f = _shard(d)
        blob = bytearray(open(f, "rb").read())
        blob[int(len(blob) * frac)] ^= 0xFF
        open(f, "wb").write(bytes(blob))

    return damage


def _remove_commit(d):
    for c in glob.glob(os.path.join(d, "step_*", "COMMIT")):
        os.remove(c)


def _edit_meta(edit):
    def damage(d):
        meta = _meta(d)
        edit(meta)
        _write_meta(d, meta)

    return damage


DAMAGE = {
    "truncated": ("f32", _truncate),
    "bitflip_10": ("f32", _flip(0.1)),
    "bitflip_50": ("f32", _flip(0.5)),
    "bitflip_90": ("f32", _flip(0.9)),
    "missing_shard": ("f32", lambda d: os.remove(_shard(d))),
    "missing_commit": ("f32", _remove_commit),
    "missing_meta": ("f32", lambda d: os.remove(os.path.join(d, "index.json"))),
    "meta_payload_mismatch": ("f32", _edit_meta(
        lambda m: m["config"].update(L=m["config"]["L"] * 2))),
    "bad_format": ("f32", _edit_meta(lambda m: m.update(format="other"))),
    "bad_version": ("f32", _edit_meta(lambda m: m.update(version=6))),
    "manifest_fill": ("f32", _edit_meta(lambda m: m["segments"][1].update(fill=3))),
    "int8_bitflip": ("int8", _flip(0.5)),
    "int8_codec_manifest_mismatch": ("int8", _edit_meta(
        lambda m: m["config"].update(storage="f32"))),
    "int8_meta_internal_codec_mismatch": ("int8", _edit_meta(
        lambda m: m["codec"].update(storage="bf16"))),
    "int8_read_as_bf16": ("int8", _edit_meta(lambda m: (m["config"].update(storage="bf16"),
                                                        m["codec"].update(storage="bf16")))),
}


def _error(load):
    try:
        load()
    except Exception as e:  # the class and message are what the test compares
        return e
    return None


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("scenario", list(DAMAGE))
def test_damage_raises_the_reference_error(tmp_path, writer, scenario):
    storage, damage = DAMAGE[scenario]
    d = _small_dir(tmp_path, writer, storage, "idx")
    damage(d)
    want = _error(lambda: japi.Index.load(d))
    got = _error(lambda: tapi.Index.load(d, device="cpu"))
    assert want is not None and got is not None, (want, got)
    assert type(got).__name__ == type(want).__name__, (got, want)
    assert isinstance(got, type(want)) or (
        isinstance(want, jckpt.CorruptCheckpointError)
        and isinstance(got, tckpt.CorruptCheckpointError))
    # the same message up to its first colon (past it: the codec's own error)
    def head(e):
        return str(e).replace(d, "<dir>").split(":")[0]

    assert head(got) == head(want)


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_intact_directory_loads_in_both(tmp_path, writer, storage):
    """Control for the damage scenarios: the undamaged directories load in
    both packages, leaf for leaf, and answer alike."""
    d = _small_dir(tmp_path, writer, storage, "ok")
    jidx, tidx = japi.Index.load(d), tapi.Index.load(d, device="cpu")
    _assert_leaves_equal(_port_leaves(tidx), _reference_leaves(jidx))
    q = np.random.default_rng(18).uniform(0, 1, (4, 8)).astype(np.float32)
    w = np.ones((4, 8), np.float32)
    alpha = 2.0 if storage == "int8" else 0.0
    _assert_same_answer(tidx.query(torch.from_numpy(q), torch.from_numpy(w),
                                   tapi.QuerySpec(k=5, screen_alpha=alpha)),
                        jidx.query(q, w, japi.QuerySpec(k=5, screen_alpha=alpha)))


def test_truncated_scales_raise_named_error(tmp_path):
    d = _small_dir(tmp_path, "port", "int8", "scales")
    idx = tapi.Index.load(d, device="cpu")
    torn = dataclasses.replace(idx.state, scales=idx.state.scales[:3])
    meta_path = os.path.join(d, "index.json")
    with pytest.raises(ValueError, match="missing or truncated"):
        tpersist._check_consistent(torn, idx.delta, idx.tombstones, idx.config, idx.update,
                                   _meta(d), meta_path)


# --- the msgpack subset --------------------------------------------------------


BOUNDARY_INTS = [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1, -1, -32,
                 -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63]
BOUNDARY_LENS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("v", BOUNDARY_INTS)
def test_msgpack_ints_at_the_width_boundaries(v):
    msgpack = pytest.importorskip("msgpack")
    p = {"crc": v, "shape": [v, 0, v]}
    assert _msgpack.packb(p) == msgpack.packb(p, use_bin_type=True)
    assert _msgpack.unpackb(msgpack.packb(p, use_bin_type=True)) == p


@pytest.mark.parametrize("n", BOUNDARY_LENS)
def test_msgpack_lengths_at_the_width_boundaries(n):
    msgpack = pytest.importorskip("msgpack")
    p = {"k" * n: "v" * n, "data": bytes(range(256)) * (n // 256) + b"x" * (n % 256),
         "shape": list(range(n)), "nested": {str(i): i for i in range(min(n, 70))}}
    packed = _msgpack.packb(p)
    assert packed == msgpack.packb(p, use_bin_type=True)
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed, raw=False) == p


@pytest.mark.parametrize("bad", [
    {"x": 1.5}, {"x": True}, {"x": None}, {1: 2}, {"x": ["a"]}, {"x": (1, 2)}, {"x": 2**64},
    {"x": -2**63 - 1}, {"x": np.int32(3)},
], ids=["float", "bool", "nil", "int_key", "str_array", "tuple", "too_big", "too_small",
        "numpy_int"])
def test_msgpack_outside_the_subset_raises(bad):
    with pytest.raises(ValueError, match="msgpack subset"):
        _msgpack.packb(bad)


@pytest.mark.parametrize("obj", [{"x": 1.5}, {"x": None}, {"x": True}, [1, "a"], {"x": {1: 2}}],
                         ids=["float", "nil", "bool", "str_array", "int_key"])
def test_msgpack_unpack_outside_the_subset_raises(obj):
    msgpack = pytest.importorskip("msgpack")
    with pytest.raises(ValueError, match="msgpack subset"):
        _msgpack.unpackb(msgpack.packb(obj, use_bin_type=True))
    packed = msgpack.packb({"a": b"xyz"}, use_bin_type=True)
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(packed[:-1])
    with pytest.raises(ValueError, match="extra data"):
        _msgpack.unpackb(packed + b"\x00")


_leaf = st.fixed_dictionaries({
    "dtype": st.sampled_from(["float32", "int32", "int8", "bool", "uint32", "bfloat16"]),
    "shape": st.lists(st.integers(0, 2**40), max_size=20),
    "data": st.binary(max_size=600),
    "crc": st.integers(0, 2**32 - 1),
})
_payloads = st.dictionaries(st.text(max_size=40), st.one_of(
    _leaf, st.integers(-2**63, 2**64 - 1), st.text(max_size=300), st.binary(max_size=300),
    st.lists(st.integers(-2**63, 2**64 - 1), max_size=20)), max_size=24)


@hypothesis.settings(max_examples=200, deadline=None)
@hypothesis.given(_payloads)
def test_msgpack_matches_msgpack_on_payload_shaped_dicts(payload):
    msgpack = pytest.importorskip("msgpack")
    packed = _msgpack.packb(payload)
    assert packed == msgpack.packb(payload, use_bin_type=True)
    assert _msgpack.unpackb(packed) == payload
