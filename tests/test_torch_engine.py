"""Port parity of the whole slice: an index built by the JAX package is
carried into ``repro_torch`` with ``Index.from_numpy`` and both packages
answer the same queries in probe and exact mode, for theta and l2 (CPU).

Bar: ids equal, dists within rtol/atol 1e-5 (tests/test_kernels_topk.py),
``n_candidates`` equal. In the exact-arithmetic fixture every sum is exact
in f32 whatever its order, so keys, sorted_keys, perm, ids and dists must be
bit-equal — including the port's own ``build_index`` on the carried tables.
"""

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
from repro.core.transforms import BoundedSpace as JSpace
from repro_torch.core import hash_families as thf
from repro_torch.core.index import _keys_for, build_index
from repro_torch.core.transforms import BoundedSpace as TSpace

N, D, M, K, L, C, B, TOPK = 2048, 16, 32, 8, 8, 32, 48, 10


def _round(x, bits):
    return (np.round(np.asarray(x, np.float64) * 2.0**bits) / 2.0**bits).astype(np.float32)


def _configs(family):
    kw = dict(d=D, M=M, K=K, L=L, family=family, W=32.0, max_candidates=C)
    return (
        japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw),
        tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw),
    )


def _leaves(jindex):
    s = jindex.state
    assert s.scales is None
    return {
        "folded": np.asarray(s.tables.folded),
        "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers),
        "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm),
        "data": np.asarray(s.data),
        "levels": np.asarray(s.levels),
        "scales": None,
    }


def _inputs(seed, exact):
    rs = np.random.default_rng(seed)
    data = rs.uniform(0, 1, (N, D)).astype(np.float32)
    q = rs.uniform(0, 1, (B, D)).astype(np.float32)
    w = rs.normal(size=(B, D)).astype(np.float32)  # mixed signs
    w[: B // 2] = np.abs(w[: B // 2]) + 0.1
    if exact:
        data, q, w = _round(data, 8), _round(q, 8), _round(w, 4)
    return data, q, w


@pytest.fixture
def exact_tables(monkeypatch):
    """Round the reference's folded tables to multiples of 2**-8, so every
    projection sum is exact in f32 (the JAX package itself is untouched)."""
    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=None):
        t = orig(key, params) if dtype is None else orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jax.numpy.asarray(_round(t.folded, 8)), offsets=t.offsets)

    monkeypatch.setattr(jhf, "make_prefix_tables", rounded)


def _both(family, exact, seed):
    jcfg, tcfg = _configs(family)
    data, q, w = _inputs(seed, exact)
    jidx = japi.Index.build(jax.random.PRNGKey(seed), data, jcfg)
    tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg, device="cpu")
    return jidx, tidx, data, q, w, tcfg


def _compare(jres, tres, exact):
    jd, ji, jn = (np.asarray(x) for x in (jres.dists, jres.ids, jres.n_candidates))
    td, ti, tn = (x.numpy() for x in (tres.dists, tres.ids, tres.n_candidates))
    assert td.shape == jd.shape and ti.dtype == np.int32
    assert np.array_equal(ti, ji)
    assert np.array_equal(tn, jn)
    if exact:
        assert np.array_equal(td, jd)
    else:
        np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["probe", "exact"])
@pytest.mark.parametrize("family", ["theta", "l2"])
def test_query_parity(family, mode):
    jidx, tidx, data, q, w, _ = _both(family, exact=False, seed=5)
    jres = jidx.query(q, w, japi.QuerySpec(k=TOPK, mode=mode))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(k=TOPK, mode=mode))
    _compare(jres, tres, exact=False)
    if mode == "probe":  # the probe really prunes, and finds something
        assert 0 < tres.n_candidates.float().mean() < N


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_exact_arithmetic_fixture_bit_equal(family, exact_tables):
    jidx, tidx, data, q, w, tcfg = _both(family, exact=True, seed=6)
    leaves = _leaves(jidx)
    # the port's own build on the carried tables: hash -> stable argsort -> pad
    own = build_index(
        None,
        torch.from_numpy(data),
        tcfg,
        tables=thf.PrefixTables(torch.from_numpy(leaves["folded"]),
                                torch.from_numpy(leaves["offsets"])),
        mixers=torch.from_numpy(leaves["mixers"]),
    )
    assert np.array_equal(own.levels.numpy(), leaves["levels"])
    assert np.array_equal(own.sorted_keys.numpy(), leaves["sorted_keys"])
    assert np.array_equal(own.perm.numpy(), leaves["perm"])
    # query keys, then both modes bit-equal
    from repro.core import transforms as jtr
    from repro.core.index import _keys_for as j_keys_for

    jq = j_keys_for(jtr.discretize(q, jidx.config.space), w, jidx.state.tables, jidx.config,
                    jidx.state.mixers)
    tq = _keys_for(tidx.state.levels.new_tensor(np.asarray(jtr.discretize(q, jidx.config.space))),
                   torch.from_numpy(w), tidx.state.tables, tcfg, tidx.state.mixers)
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    for mode in ("probe", "exact"):
        jres = jidx.query(q, w, japi.QuerySpec(k=TOPK, mode=mode))
        own_idx = tapi.Index(state=own, config=tcfg)
        for idx in (tidx, own_idx):
            tres = idx.query(torch.from_numpy(q), torch.from_numpy(w),
                             tapi.QuerySpec(k=TOPK, mode=mode))
            _compare(jres, tres, exact=True)


def test_cpu_build_is_deterministic_and_self_consistent():
    """The port's own build from a seed: same seed, same index; probe
    results are a subset of rows, exact results are the brute force."""
    _, tcfg = _configs("theta")
    data, q, w = _inputs(7, exact=False)
    a = tapi.Index.build(3, data, tcfg, device="cpu")
    b = tapi.Index.build(3, data, tcfg, device="cpu")
    assert torch.equal(a.state.perm, b.state.perm)
    assert torch.equal(a.state.tables.folded, b.state.tables.folded)
    res = a.query(q, w, tapi.QuerySpec(k=TOPK))
    ex = a.query(q, w, tapi.QuerySpec(k=TOPK, mode="exact"))
    dist = (torch.from_numpy(w)[:, None] * (torch.from_numpy(data)[None]
                                            - torch.from_numpy(q)[:, None]).abs()).sum(-1)
    assert torch.equal(ex.ids.long(), torch.sort(dist, dim=1, stable=True).indices[:, :TOPK])
    # the i-th probe result is never closer than the true i-th neighbour
    assert torch.all(res.dists >= ex.dists - 1e-5)
    assert torch.all((res.ids >= 0) == torch.isfinite(res.dists))
    assert torch.all(res.n_candidates <= N)
