"""Port parity of the mutable lifecycle: insert, delete, the two-segment
query and compact (CPU).

A mutable index built, inserted into and deleted from by the JAX package is
carried into ``repro_torch`` with ``Index.from_numpy`` (its sealed leaves,
its delta leaves and its tombstones); both packages answer the same probe,
multiprobe and exact queries. Bar: ids equal, dists within rtol/atol 1e-5
(tests/test_kernels_topk.py), ``n_candidates`` equal. In the
exact-arithmetic fixture every projection sum is exact in f32 whatever its
order, so the port's own inserts give keys, levels and ids bit-equal to the
reference's. The primitives — ``tombstone_ids``, the chunked delta key
match, the plain two-segment gather and ``compact`` — are held against the
reference's and against their own definitions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
from repro.core import index as jcore
from repro.core.transforms import BoundedSpace as JSpace
from repro.kernels import ref as jref
from repro_torch import quant as tquant
from repro_torch.core import index as tcore
from repro_torch.core.transforms import BoundedSpace as TSpace
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

N, D, M, K, L, C, B, TOPK, CAP = 2048, 16, 32, 8, 8, 32, 48, 10, 256


def _round(x, bits):
    return (np.round(np.asarray(x, np.float64) * 2.0**bits) / 2.0**bits).astype(np.float32)


def _configs(family, storage="f32"):
    kw = dict(d=D, M=M, K=K, L=L, family=family, W=32.0, max_candidates=C, storage=storage)
    return (
        japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw),
        tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw),
    )


def _leaves(jindex, delta=True):
    """The reference index's leaves as numpy arrays, as ``from_numpy`` takes them."""
    s = jindex.state
    out = {
        "folded": np.asarray(s.tables.folded),
        "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers),
        "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm),
        "data": np.asarray(s.data),
        "levels": np.asarray(s.levels),
        "scales": None if s.scales is None else np.asarray(s.scales),
    }
    if delta:
        out.update(
            delta_data=np.asarray(jindex.delta.data),
            delta_levels=np.asarray(jindex.delta.levels),
            delta_keys=np.asarray(jindex.delta.keys),
            delta_fill=np.asarray(jindex.delta.fill),
            tombstones=np.asarray(jindex.tombstones),
        )
    return out


def _problem(seed, exact=False):
    """Rows, rows to insert, and a query batch whose first 16 queries sit on
    inserted rows (so the delta segment answers them)."""
    rs = np.random.default_rng(seed)
    data = rs.uniform(0, 1, (N, D)).astype(np.float32)
    extra = rs.uniform(0, 1, (CAP + 40, D)).astype(np.float32)
    q = rs.uniform(0, 1, (B, D)).astype(np.float32)
    q[:16] = extra[:16]
    w = rs.normal(size=(B, D)).astype(np.float32)  # mixed signs
    w[: B // 2] = np.abs(w[: B // 2]) + 0.1
    if exact:
        data, extra, q, w = _round(data, 8), _round(extra, 8), _round(q, 8), _round(w, 4)
    return data, extra, q, w


@pytest.fixture
def exact_tables(monkeypatch):
    """Round the reference's folded tables to multiples of 2**-8, so every
    projection sum is exact in f32 (the JAX package itself is untouched)."""
    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=None):
        t = orig(key, params) if dtype is None else orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jax.numpy.asarray(_round(t.folded, 8)), offsets=t.offsets)

    monkeypatch.setattr(jhf, "make_prefix_tables", rounded)


def _mutated_pair(family, storage, seed=3):
    """The same mutable index in both packages: built and mutated by the
    reference (200 inserts, 60 main and 10 delta rows deleted), carried over."""
    jcfg, tcfg = _configs(family, storage)
    data, extra, q, w = _problem(seed)
    jidx = japi.Index.build(jax.random.PRNGKey(seed), data, jcfg,
                            update=japi.UpdateSpec(delta_capacity=CAP))
    jidx, ids = jidx.insert(extra[:200])
    jidx = jidx.delete(jnp.arange(0, 120, 2, dtype=jnp.int32))
    jidx = jidx.delete(ids[::20])
    tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                                 device="cpu")
    return jidx, tidx, q, w


_PAIRS = {}


def _pair(family, storage):
    if (family, storage) not in _PAIRS:
        _PAIRS[(family, storage)] = _mutated_pair(family, storage)
    return _PAIRS[(family, storage)]


QUERY_CASES = [
    (family, storage, alpha, mode)
    for family in ("theta", "l2")
    for storage, alpha in (("f32", 0.0), ("int8", 2.0), ("int8", 0.0))
    for mode in ("probe", "multiprobe", "exact")
    if not (mode == "multiprobe" and family == "l2")  # l2 has no multiprobe (reference too)
    and not (mode == "exact" and alpha)  # exact folds the screen away
]


@pytest.mark.parametrize("family,storage,alpha,mode", QUERY_CASES)
def test_mutable_query_parity(family, storage, alpha, mode):
    jidx, tidx, q, w = _pair(family, storage)
    assert tidx.mutable and tidx.delta_fill == int(jidx.delta.fill) == 200
    assert tidx.n_live == jidx.n_live and tidx.table_bytes == jidx.table_bytes
    spec = dict(k=TOPK, mode=mode, screen_alpha=alpha)
    jres = jidx.query(q, w, japi.QuerySpec(**spec))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec))
    ji, jd, jn = (np.asarray(x) for x in (jres.ids, jres.dists, jres.n_candidates))
    assert np.array_equal(tres.ids.numpy(), ji)
    assert np.array_equal(tres.n_candidates.numpy(), jn)
    np.testing.assert_allclose(tres.dists.numpy(), jd, rtol=1e-5, atol=1e-5)
    found = tres.ids.numpy()
    assert (found >= N).any(), "degenerate test: no delta row in any result"
    dead = np.nonzero(tidx.tombstones.numpy())[0]
    assert not np.isin(found, dead).any()


@pytest.mark.parametrize("storage", ["f32", "int8"])
@pytest.mark.parametrize("family", ["theta", "l2"])
def test_insert_bit_equal_in_exact_arithmetic(family, storage, exact_tables):
    """The port's own inserts into a carried sealed index: keys, levels,
    encoded rows, fill and ids (-1 past the capacity) equal the reference's."""
    jcfg, tcfg = _configs(family, storage)
    data, extra, q, w = _problem(11, exact=True)
    extra[5, 2] = 3.0  # outside the sealed int8 range: saturates to 127 in both
    cap = 64
    jidx = japi.Index.build(jax.random.PRNGKey(11), data, jcfg,
                            update=japi.UpdateSpec(delta_capacity=cap))
    tidx = tapi.Index.from_numpy(_leaves(jidx, delta=False), tcfg,
                                 update=tapi.UpdateSpec(delta_capacity=cap), device="cpu")
    for lo, hi in ((0, 50), (50, 80), (80, 85)):  # the second batch overflows
        jidx, jids = jidx.insert(extra[lo:hi])
        tidx, tids = tidx.insert(extra[lo:hi])
        assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert tidx.delta_fill == int(jidx.delta.fill) == cap
    assert (tids.numpy() == -1).all()
    assert np.array_equal(tidx.delta.keys.numpy(), np.asarray(jidx.delta.keys))
    assert np.array_equal(tidx.delta.levels.numpy(), np.asarray(jidx.delta.levels))
    assert np.array_equal(tidx.delta.data.numpy(), np.asarray(jidx.delta.data))
    jres = jidx.query(q, w, japi.QuerySpec(k=TOPK))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(k=TOPK))
    assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    assert np.array_equal(tres.n_candidates.numpy(), np.asarray(jres.n_candidates))


def test_tombstone_ids_ignores_unassigned_ids():
    """Deleting an id no insert has handed out is a no-op — not a
    pre-tombstone on the slot a future insert will occupy."""
    _, tcfg = _configs("theta")
    data, extra, _, _ = _problem(12)
    idx = tapi.Index.build(0, data, tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                           device="cpu")
    idx = idx.delete(torch.tensor([N + 3, N + CAP + 5, -7], dtype=torch.int32))
    assert idx.n_live == N and not bool(idx.tombstones.any())
    idx, ids = idx.insert(extra[:5])
    res = idx.query(extra[:5], np.ones((5, D), np.float32), tapi.QuerySpec(k=1))
    assert torch.equal(res.ids[:, 0], ids)
    # against the reference's tombstone_ids, on ids of every kind
    rs = np.random.default_rng(13)
    tomb = rs.random(N + CAP) < 0.1
    probe_ids = rs.integers(-20, N + CAP + 20, 300).astype(np.int32)
    for fill in (0, 17, CAP):
        want = jcore.tombstone_ids(jnp.asarray(tomb), jnp.asarray(probe_ids), N,
                                   jnp.asarray(fill, jnp.int32))
        got = tcore.tombstone_ids(torch.from_numpy(tomb), torch.from_numpy(probe_ids), N, fill)
        assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fill_share", [1.0, 0.4])
@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("cap", [1, 64, 130, 256])
def test_delta_candidates_chunked_equals_dense(cap, P, fill_share):
    """The chunked key match (block 1, 7 and >= cap; capacity not a block
    multiple; a partly filled delta) equals the dense (b, L, P, cap) match
    and the reference's."""
    Lt, b, n_main = 6, 7, 100
    rs = np.random.default_rng(cap * 10 + P)
    dkeys = rs.integers(0, 13, (Lt, cap)).astype(np.int32)  # small alphabet: real collisions
    pk = rs.integers(0, 13, (b, Lt, P)).astype(np.int32)
    fill = max(1, int(cap * fill_share))
    live = (rs.random(cap) < 0.8) & (np.arange(cap) < fill)
    sentinel = n_main + cap
    dense = (pk[:, :, :, None] == dkeys[None, :, None, :]).any(axis=(1, 2))
    want = np.where(dense & live[None, :], n_main + np.arange(cap, dtype=np.int32), sentinel)
    assert dense.any(), "degenerate test: no collisions"
    delta = tcore.DeltaSegment(data=torch.zeros((cap, D)),
                               levels=torch.zeros((cap, D), dtype=torch.int32),
                               keys=torch.from_numpy(dkeys), fill=fill)
    jdelta = jcore.DeltaSegment(data=jnp.zeros((cap, D)), levels=jnp.zeros((cap, D), jnp.int32),
                                keys=jnp.asarray(dkeys), fill=jnp.asarray(fill, jnp.int32))
    ref = jcore._delta_candidates(jnp.asarray(pk), jdelta, jnp.asarray(live), n_main, sentinel)
    assert np.array_equal(np.asarray(ref), want)
    for block in (1, 7, cap, 1024):
        got = tcore._delta_candidates(torch.from_numpy(pk), delta, torch.from_numpy(live),
                                      n_main, sentinel, block=block)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def _segmented_inputs(n_main, cap, P, b, codec, seed):
    rs = np.random.default_rng(seed)
    main = rs.uniform(0, 1, (n_main, D)).astype(np.float32)
    delta = rs.uniform(0, 1, (cap, D)).astype(np.float32)
    q = rs.uniform(0, 1, (b, D)).astype(np.float32)
    w = rs.normal(size=(b, D)).astype(np.float32)  # negative weights too
    n_tot = n_main + cap
    ids = rs.integers(-3, n_tot + n_tot // 3, (b, P)).astype(np.int32)  # ~25% invalid
    main_t, scales = tquant.get_codec(codec).encode(torch.from_numpy(main))
    delta_t = tquant.get_codec(codec).encode_rows(torch.from_numpy(delta), scales)
    return main_t, delta_t, scales, torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(w)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("shape", [(100, 40, 64, 3), (600, 250, 777, 10), (5, 1, 9, 4)])
def test_segmented_gather_equals_concatenated_table(shape, codec):
    """The plain two-segment tail returns bit for bit the single-table tail
    over cat([main, delta]) — ids in both segments, invalid ids on both
    sides, k > #valid — and agrees with the reference's oracle."""
    n_main, cap, P, k = shape
    main, delta, scales, ids, q, w = _segmented_inputs(n_main, cap, P, 4, codec, n_main + P)
    ids[0] = n_main + cap  # an all-invalid row
    got = tops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta)
    want = tref.gather_rerank_topk(torch.cat([main, delta]), ids, q, w, k, scales=scales)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.all(got[1][0] == -1) and torch.all(torch.isinf(got[0][0]))
    jmain, jdelta = (jnp.asarray(np.asarray(t.float() if t.dtype == torch.bfloat16 else t))
                     for t in (main, delta))
    if codec == "bf16":
        jmain, jdelta = jmain.astype(jnp.bfloat16), jdelta.astype(jnp.bfloat16)
    jids = np.where(ids.numpy() < 0, n_main + cap, ids.numpy())  # the oracle's invalid ids are >= n
    jd, ji = jref.gather_rerank_topk_segmented(
        jmain, jdelta, jnp.asarray(jids), jnp.asarray(q.numpy()), jnp.asarray(w.numpy()), k,
        scales=None if scales is None else jnp.asarray(scales.numpy()))
    assert np.array_equal(got[1].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_segmented_gather_delta_cast_through_main_dtype():
    """A delta held in another dtype is cast through the main table's."""
    main, delta, _, ids, q, w = _segmented_inputs(50, 20, 40, 3, "bf16", 5)
    got = tops.gather_rerank_topk(main, ids, q, w, 5, delta=delta.float())
    want = tops.gather_rerank_topk(main, ids, q, w, 5, delta=delta)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_compact_matches_reference_and_fresh_build(storage):
    """compact() equals the reference's compaction of the same state, leaf
    for leaf, and the port's own build over the survivors with the same
    tables and mixers (int8: the survivors' codes refit to new scales)."""
    jidx, tidx, q, w = _pair("theta", storage)
    jc, tc = jidx.compact(), tidx.compact()
    assert tc.delta_fill == 0 and tc.n == tidx.n_live == jc.n
    assert not bool(tc.tombstones.any()) and tc.capacity == tc.n + CAP
    for name in ("sorted_keys", "perm", "levels", "data", "scales"):
        a, b = getattr(tc.state, name), getattr(jc.state, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert np.array_equal(tidx.live_ids(), jidx.live_ids())
    # the port's own mutable index against its own build over the survivors'
    # raw rows, with the same tables and mixers
    _, tcfg = _configs("theta", storage)
    data, extra, q, w = _problem(17)
    own = tapi.Index.build(6, data, tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                           device="cpu")
    own, ids = own.insert(extra[:150])
    own = own.delete(torch.cat([torch.arange(0, 300, 3, dtype=torch.int32), ids[::7]]))
    oc = own.compact()
    survivors = torch.from_numpy(np.concatenate([data, extra[:CAP]])[own.live_ids()])
    fresh = tcore.build_index(None, survivors, tcfg, tables=own.state.tables,
                              mixers=own.state.mixers)
    for name in ("sorted_keys", "perm", "levels"):
        assert torch.equal(getattr(oc.state, name), getattr(fresh, name)), name
    # the payload: the survivors decoded with the old scales, re-encoded (int8: refit)
    decoded = torch.cat([tquant.decode_table(own.state.data, own.state.scales),
                         tquant.decode_table(own.delta.data, own.state.scales)])
    payload, scales = tquant.get_codec(storage).encode(decoded[torch.from_numpy(own.live_ids())])
    assert torch.equal(oc.state.data, payload)
    if storage == "f32":
        assert torch.equal(oc.state.data, fresh.data) and oc.state.scales is None
    else:
        assert torch.equal(oc.state.scales, scales)
    qt, wt = torch.from_numpy(q), torch.from_numpy(np.abs(w))
    exact = tapi.QuerySpec(k=5, mode="exact")
    before, after = own.query(qt, wt, exact), oc.query(qt, wt, exact)
    if storage == "f32":  # the same rows, renumbered per live_ids
        assert torch.equal(after.dists, before.dists)
        assert np.array_equal(own.live_ids()[after.ids.numpy()], before.ids.numpy())
    else:  # refit scales: within the re-quantization budget (tests/test_quant.py)
        np.testing.assert_allclose(after.dists.numpy(), before.dists.numpy(), rtol=0, atol=0.1)


def test_no_tombstoned_id_ever_reaches_a_result():
    """Rows deleted from either segment never come back, in any mode, even
    for queries that sit exactly on them."""
    _, tcfg = _configs("theta")
    data, extra, _, w = _problem(14)
    idx = tapi.Index.build(1, data, tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                           device="cpu")
    idx, ids = idx.insert(extra[:100])
    dead = torch.cat([torch.arange(0, 400, 3, dtype=torch.int32), ids[::2]])
    idx = idx.delete(dead)
    q = torch.cat([torch.from_numpy(data[0:400:3][:24]), torch.from_numpy(extra[:100:2][:24])])
    for spec in (tapi.QuerySpec(k=TOPK), tapi.QuerySpec(k=TOPK, mode="multiprobe"),
                 tapi.QuerySpec(k=TOPK, mode="exact")):
        res = idx.query(q, torch.from_numpy(np.abs(w)), spec)
        assert not torch.isin(res.ids, dead).any(), spec.mode
        assert bool((res.ids >= 0).all())


def test_empty_delta_answers_as_the_sealed_index():
    """A mutable index before any insert answers as the sealed index, bit
    for bit, though its ids address main plus delta capacity."""
    _, tcfg = _configs("theta")
    data, _, q, w = _problem(15)
    sealed = tapi.Index.build(4, data, tcfg, device="cpu")
    mut = tapi.Index.build(4, data, tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                           device="cpu")
    for mode in ("probe", "multiprobe", "exact"):
        a = sealed.query(q, w, tapi.QuerySpec(k=TOPK, mode=mode))
        b = mut.query(q, w, tapi.QuerySpec(k=TOPK, mode=mode))
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists), mode
        if mode != "exact":
            assert torch.equal(a.n_candidates, b.n_candidates)


def test_lifecycle_is_functional_and_refused_on_a_sealed_index():
    _, tcfg = _configs("theta")
    data, extra, q, w = _problem(16)
    idx = tapi.Index.build(5, data, tcfg, update=tapi.UpdateSpec(delta_capacity=CAP),
                           device="cpu")
    before = idx.query(q, w, tapi.QuerySpec(k=TOPK))
    grown, _ = idx.insert(extra[:50])
    shrunk = grown.delete(torch.arange(0, 200, dtype=torch.int32))
    after = idx.query(q, w, tapi.QuerySpec(k=TOPK))  # the old index is untouched
    assert idx.delta_fill == 0 and grown.delta_fill == 50 and not bool(grown.tombstones.any())
    assert shrunk.n_live == N + 50 - 200
    assert torch.equal(before.ids, after.ids)
    sealed = tapi.Index.build(5, data, tcfg, device="cpu")
    assert not sealed.mutable and sealed.capacity == N and not sealed.needs_compact
    for op, arg in (("insert", extra[:2]), ("delete", [0])):
        with pytest.raises(ValueError, match="requires a mutable index"):
            getattr(sealed, op)(arg)
    with pytest.raises(ValueError, match="requires a mutable index"):
        sealed.compact()
    with pytest.raises(ValueError, match="trailing dim config.d"):
        idx.insert(np.zeros((2, D + 1), np.float32))


def test_serve_stream_runs_on_cpu_through_a_compact(capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "stream", "--device", "cpu", "--n", "2048", "--d", "8", "--K", "4",
                "--L", "4", "--query-batch", "16", "--batches", "3", "--ingest", "64",
                "--retire", "16", "--delta-capacity", "128"])
    out = capsys.readouterr().out
    assert "[stream] built mutable index n=2048 d=8 delta_capacity=128" in out
    assert "[stream] tick 2:" in out and "delta=64/128" in out
    assert "[stream] compacted to n=2144 (delta emptied)" in out  # 2048 + 128 - 32
