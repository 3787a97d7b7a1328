"""Port parity of the streamed early-exit query, the paper's theory and
``Index.explain`` (CPU).

Indexes are built (and, for a mutable one, inserted into and deleted from)
by the JAX package and carried into ``repro_torch`` with
``Index.from_numpy``; both packages answer the same streamed queries. Bar:
ids, ``n_candidates``, ``tables_probed`` and ``stop_reason`` equal, dists
within rtol/atol 1e-5 (tests/test_kernels_topk.py). At ``exit_slack=0`` the
port's streamed answer also equals its own monolithic answer bit for bit
(the candidate rows sit at σ=1e-3 from the queries, so no distance is 0).
The theory functions agree with the reference's within rtol 1e-6 in f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro_torch.api as tapi
from repro.core import theory as jtheory
from repro.core.transforms import BoundedSpace as JSpace
from repro.engine import stream as jstream
from repro_torch.core import theory as ttheory
from repro_torch.core.transforms import BoundedSpace as TSpace
from repro_torch.engine import pipeline as tpipeline
from repro_torch.engine import stream as tstream

N, D, M, CAP, B, TOPK = 400, 8, 8, 64, 12, 5


def _configs(family, storage="f32", **kw):
    kw = dict(d=D, M=M, K=6, L=10, family=family, W=32.0, max_candidates=N + CAP,
              storage=storage) | kw
    return (japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw),
            tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw))


def _leaves(jindex):
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
    if jindex.mutable:
        out.update(
            delta_data=np.asarray(jindex.delta.data),
            delta_levels=np.asarray(jindex.delta.levels),
            delta_keys=np.asarray(jindex.delta.keys),
            delta_fill=np.asarray(jindex.delta.fill),
            tombstones=np.asarray(jindex.tombstones),
        )
    return out


def _problem(seed=0):
    """Rows in tight clusters around the first half of the queries (σ=1e-3,
    so those queries can stop early), uniform filler, and rows to insert
    (the first four near the next queries, so the delta answers them)."""
    rs = np.random.default_rng(seed)
    q = (rs.uniform(0, 1, (B, D)) * 0.8 + 0.1).astype(np.float32)
    near = q[: B // 2, None, :] + 1e-3 * rs.normal(size=(B // 2, 8, D))
    filler = rs.uniform(0, 1, (N - 8 * (B // 2), D))
    data = np.concatenate([near.reshape(-1, D), filler]).astype(np.float32)
    extra = rs.uniform(0, 1, (37, D)).astype(np.float32)
    extra[:4] = q[B // 2 : B // 2 + 4] + 1e-3 * rs.normal(size=(4, D))
    w = (np.abs(rs.normal(size=(B, D))) + 0.2).astype(np.float32)
    return data, extra, q, w


def _pair(family, view, storage="f32", **cfg_kw):
    """The same index in both packages: ``view`` "sealed" or "mutable" (37
    inserts, three main and two delta rows deleted)."""
    jcfg, tcfg = _configs(family, storage, **cfg_kw)
    data, extra, _, _ = _problem()
    key = jax.random.PRNGKey(9)
    if view == "sealed":
        jidx = japi.Index.build(key, data, jcfg)
        update = tapi.UpdateSpec()
    else:
        jidx = japi.Index.build(key, data, jcfg, update=japi.UpdateSpec(delta_capacity=CAP))
        jidx, ids = jidx.insert(extra)
        jidx = jidx.delete(jnp.asarray([0, 5, 17, int(ids[3]), int(ids[11])], jnp.int32))
        update = tapi.UpdateSpec(delta_capacity=CAP)
    tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg, update=update, device="cpu")
    return jidx, tidx


_PAIRS = {}


def _cached_pair(family, view, storage):
    if (family, view, storage) not in _PAIRS:
        _PAIRS[(family, view, storage)] = _pair(family, view, storage)
    return _PAIRS[(family, view, storage)]


def _run(jidx, tidx, q, w, **spec):
    jres = jidx.query(q, w, japi.QuerySpec(**spec))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec))
    return jres, tres


def _assert_parity(jres, tres):
    assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=1e-5, atol=1e-5)
    assert np.array_equal(tres.n_candidates.numpy(), np.asarray(jres.n_candidates))
    if jres.tables_probed is None:
        assert tres.tables_probed is None and tres.stop_reason is None
    else:
        assert tres.tables_probed.dtype == torch.int32 and tres.stop_reason.dtype == torch.int32
        assert np.array_equal(tres.tables_probed.numpy(), np.asarray(jres.tables_probed))
        assert np.array_equal(tres.stop_reason.numpy(), np.asarray(jres.stop_reason))


def _assert_bit_identical(got, want):
    for f in ("ids", "dists", "n_candidates"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


# ---------------------------------------------------------------------------
# window order and theory
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L,P,G", [(10, 3, 4), (32, 1, 8), (7, 8, 3), (5, 1, 5), (4, 2, 16)])
def test_window_order_equal(L, P, G):
    got, want = tstream.window_order(L, P, G), jstream.window_order(L, P, G)
    assert got[2:] == want[2:]
    for g, w_ in zip(got[:2], want[:2]):
        assert g.dtype == np.int32 and np.array_equal(g, w_)
    assert (tstream.STOP_EXHAUSTED, tstream.STOP_GEOMETRIC, tstream.STOP_CONFIDENCE) == (
        jstream.STOP_EXHAUSTED, jstream.STOP_GEOMETRIC, jstream.STOP_CONFIDENCE)


def _theory_inputs():
    rs = np.random.default_rng(5)
    w = (np.abs(rs.normal(size=(6, 16))) + 0.1).astype(np.float32)  # per-query weights
    r = (rs.uniform(0.5, 40.0, 6)).astype(np.float32)  # one radius per query
    return r, w


def _close(got, want, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=0)


THEORY_FORWARD = {
    "p_theta": lambda th, r, w: th.p_theta(r / 40.0),
    "p_l2": lambda th, r, w: th.p_l2(r, 30.0),
    "l2_distance_from_wl1": lambda th, r, w: th.l2_distance_from_wl1(r, 16, 16, w),
    "angular_distance_from_wl1": lambda th, r, w: th.angular_distance_from_wl1(r, 16, 16, w),
    "collision_prob_l2": lambda th, r, w: th.collision_prob_l2(r, 16, 16, w, 30.0),
    "collision_prob_theta": lambda th, r, w: th.collision_prob_theta(r, 16, 16, w),
    "rho_theta": lambda th, r, w: th.rho(r, 2 * r, 16, 16, w),
    "rho_l2": lambda th, r, w: th.rho(r, 2 * r, 16, 16, w, family="l2", W=30.0),
    "wl1_from_l2_distance": lambda th, r, w: th.wl1_from_l2_distance(r + 40.0, 16, 16, w),
    "wl1_from_angular_distance": lambda th, r, w: th.wl1_from_angular_distance(r / 40.0, 16, 16,
                                                                               w),
}


@pytest.mark.parametrize("name", list(THEORY_FORWARD))
def test_theory_forward_curves_equal(name):
    """Arrays of radii at per-query weights, both families, rho and the
    Eq 24/26 inverses, in f32."""
    r, w = _theory_inputs()
    fn = THEORY_FORWARD[name]
    got = fn(ttheory, torch.from_numpy(r), torch.from_numpy(w))
    assert got.dtype == torch.float32
    _close(got.numpy(), fn(jtheory, jnp.asarray(r), jnp.asarray(w)))


def test_theory_inverses_round_trip():
    """The Eq 24/26 inverses undo the forward maps (f32 rounding of a
    ~10^3-sized difference bounds the tolerance)."""
    r, w = _theory_inputs()
    r, w = torch.from_numpy(r), torch.from_numpy(w)
    s = ttheory.l2_distance_from_wl1(r, 16, 16, w)
    _close(ttheory.wl1_from_l2_distance(s, 16, 16, w).numpy(), r.numpy(), rtol=1e-4)
    ang = ttheory.angular_distance_from_wl1(r, 16, 16, w)
    _close(ttheory.wl1_from_angular_distance(ang, 16, 16, w).numpy(), r.numpy(), rtol=1e-3)


def test_theory_solvers_equal():
    for p, W in ((0.5, 4.0), (0.9, 30.0), (0.05, 8.0)):
        _close(ttheory.invert_p_l2(p, W), jtheory.invert_p_l2(p, W))
    for P2, n in ((0.3, 1000), (0.9, 262144), (0.999, 10**6)):
        assert ttheory.solve_K(P2, n) == jtheory.solve_K(P2, n)
    for args in ((0.9, 0.3, 1000), (0.8, 0.5, 262144, 0.1), (0.99, 0.2, 50, 0.5, 4, 8)):
        assert ttheory.solve_tables(*args) == jtheory.solve_tables(*args)
    for s1, s2 in ((10.0, 20.0), (3.0, 30.0), (40.0, 41.0)):
        _close(ttheory.solve_bucket_width(s1, s2), jtheory.solve_bucket_width(s1, s2))
    sample = np.random.default_rng(3).exponential(5.0, 200)
    for kw in ({}, {"quantile": 0.9}, {"r_max": 3.0}):
        assert ttheory.operating_radii(sample, 2.0, **kw) == jtheory.operating_radii(
            sample, 2.0, **kw)
    for family in ("theta", "l2"):
        got = ttheory.plan_index(10_000, 2.0, 8.0, 8, 16, family=family, W=30.0)
        want = jtheory.plan_index(10_000, 2.0, 8.0, 8, 16, family=family, W=30.0)
        assert (got.K, got.L) == (want.K, want.L)
        _close([got.rho, got.P1, got.P2], [want.rho, want.P1, want.P2])
        _close(ttheory.success_probability(got), jtheory.success_probability(want))
    with pytest.raises(ValueError, match="P2"):
        ttheory.solve_K(1.0, 10)


# ---------------------------------------------------------------------------
# the streamed query against the reference
# ---------------------------------------------------------------------------

STREAM_CASES = [
    (family, mode, view, storage, slack)
    for family in ("theta", "l2")
    for mode in ("probe", "multiprobe")
    for view in ("sealed", "mutable")
    for storage in ("f32", "int8")
    for slack in (0.0, 0.4)
    if not (family == "l2" and mode == "multiprobe")  # l2 has no multiprobe (reference too)
]


@pytest.mark.parametrize("family,mode,view,storage,slack", STREAM_CASES)
def test_streamed_query_matches_reference(family, mode, view, storage, slack):
    """Streamed early exit (int8 with the screen off) equals the reference;
    at slack 0 it also equals the port's monolithic query bit for bit and
    every query exhausts the lattice."""
    jidx, tidx = _cached_pair(family, view, storage)
    _, _, q, w = _problem()
    spec = dict(k=TOPK, mode=mode, n_probes=4, max_flips=2, early_exit=True, exit_group=4,
                exit_slack=slack)
    jres, tres = _run(jidx, tidx, q, w, **spec)
    _assert_parity(jres, tres)
    assert tres.tables_probed is not None
    if view == "mutable":
        assert (tres.ids.numpy() >= N).any(), "degenerate: no delta row in any result"
        dead = np.nonzero(tidx.tombstones.numpy())[0]
        assert not np.isin(tres.ids.numpy(), dead).any()
    P = 1 if mode == "probe" else 4
    if slack == 0.0:
        off = tidx.query(torch.from_numpy(q), torch.from_numpy(w),
                         tapi.QuerySpec(k=TOPK, mode=mode, n_probes=4, max_flips=2))
        _assert_bit_identical(tres, off)
        assert (tres.tables_probed == tidx.config.L * P).all()
        assert (tres.stop_reason == tstream.STOP_EXHAUSTED).all()
    else:
        assert (tres.stop_reason == tstream.STOP_CONFIDENCE).any(), "degenerate: no early stop"
        assert (tres.tables_probed < tidx.config.L * P).any()


def test_negative_weights_disable_the_geometric_stop():
    """Mixed-sign weights void the zero bound: the streamed answer at slack 0
    equals the monolithic one and every query exhausts, as in the reference."""
    jidx, tidx = _cached_pair("theta", "sealed", "f32")
    _, _, q, _ = _problem()
    w = np.random.default_rng(77).normal(size=q.shape).astype(np.float32)
    jres, tres = _run(jidx, tidx, q, w, k=TOPK, early_exit=True, exit_group=4, exit_slack=0.0)
    _assert_parity(jres, tres)
    _assert_bit_identical(tres, tidx.query(torch.from_numpy(q), torch.from_numpy(w),
                                           tapi.QuerySpec(k=TOPK)))
    assert (tres.stop_reason == tstream.STOP_EXHAUSTED).all()


def test_geometric_stop_in_the_first_group():
    """k exact duplicates of each query at distance 0: every query stops
    after the first group (geometric), in both packages."""
    k, b = 4, 3
    rs = np.random.default_rng(8)
    q = rs.uniform(0, 1, (b, D)).astype(np.float32)
    data = np.concatenate([np.repeat(q, k, axis=0),
                           rs.uniform(0, 1, (N - b * k, D))]).astype(np.float32)
    jcfg, tcfg = _configs("theta")
    jidx = japi.Index.build(jax.random.PRNGKey(4), data, jcfg)
    tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg, device="cpu")
    w = np.ones((b, D), np.float32)
    jres, tres = _run(jidx, tidx, q, w, k=k, early_exit=True, exit_group=4, exit_slack=0.0)
    _assert_parity(jres, tres)
    assert (tres.stop_reason == tstream.STOP_GEOMETRIC).all()
    assert (tres.tables_probed == 4).all() and (tres.dists == 0).all()
    assert np.array_equal(tres.ids.numpy(), np.arange(b * k).reshape(b, k))


@pytest.mark.parametrize("G", [3, 4, 7])
def test_group_that_does_not_divide_the_lattice(G):
    """L=10: the padded last group repeats a window, which dedupes away."""
    jidx, tidx = _cached_pair("theta", "mutable", "f32")
    _, _, q, w = _problem()
    jres, tres = _run(jidx, tidx, q, w, k=TOPK, early_exit=True, exit_group=G, exit_slack=0.0)
    _assert_parity(jres, tres)
    _assert_bit_identical(tres, tidx.query(torch.from_numpy(q), torch.from_numpy(w),
                                           tapi.QuerySpec(k=TOPK)))
    assert (tres.tables_probed == 10).all()


@pytest.mark.parametrize("fold", ["exact", "screen", "one_group"])
def test_folds_to_the_monolithic_tail(fold):
    """Where the reference's normalize_static_args folds early exit off, the
    port runs the monolithic tail too: no tables_probed, the same answer."""
    storage = "int8" if fold == "screen" else "f32"
    jidx, tidx = _cached_pair("theta", "sealed", storage)
    _, _, q, w = _problem()
    tq, tw = torch.from_numpy(q), torch.from_numpy(w)
    if fold == "exact":  # QuerySpec refuses it; the engine entry folds it
        got = tpipeline.query(tidx.state, None, None, tq, tw, tidx.config, k=TOPK, mode="exact",
                              early_exit=True, exit_group=4)
        want = tidx.query(tq, tw, tapi.QuerySpec(k=TOPK, mode="exact"))
    else:
        spec = dict(k=TOPK, early_exit=True, exit_group=4, exit_slack=0.1)
        if fold == "screen":
            spec["screen_alpha"] = 2.0
        else:
            spec["exit_group"] = 10  # one group covers L·P = 10 windows
        jres, got = _run(jidx, tidx, q, w, **spec)
        _assert_parity(jres, got)
        off = dict(spec, early_exit=False)
        want = tidx.query(tq, tw, tapi.QuerySpec(**off))
    assert got.tables_probed is None and got.stop_reason is None
    _assert_bit_identical(got, want)


# ---------------------------------------------------------------------------
# Index.explain
# ---------------------------------------------------------------------------

EXPLAIN_CASES = [
    ("theta", "sealed", "f32", dict(k=TOPK, early_exit=True, exit_group=4, exit_slack=0.4)),
    ("theta", "sealed", "f32", dict(k=TOPK)),
    ("theta", "mutable", "int8", dict(k=TOPK, mode="multiprobe", n_probes=4, max_flips=2,
                                      screen_alpha=2.0)),
    ("l2", "mutable", "f32", dict(k=TOPK, early_exit=True, exit_group=3, exit_slack=0.1)),
    ("theta", "sealed", "int8", dict(k=TOPK, mode="exact")),
]


@pytest.mark.parametrize("family,view,storage,spec", EXPLAIN_CASES)
def test_explain_matches_reference(family, view, storage, spec):
    """Every QueryReport field and to_dict() equal the reference's. A small
    window (C=8) makes truncated_tables non-zero."""
    jidx, tidx = _pair(family, view, storage, max_candidates=8)
    _, _, q, w = _problem()
    jrep = jidx.explain(q, w, japi.QuerySpec(**spec))
    trep = tidx.explain(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec))
    assert isinstance(trep, tapi.QueryReport) and trep.spec == tapi.QuerySpec(**spec)
    _assert_parity(jrep.result, trep.result)
    np.testing.assert_allclose(trep.predicted_success, np.asarray(jrep.predicted_success),
                               rtol=1e-5, atol=1e-6)
    for f in ("n_candidates", "truncated_tables", "n_invalid", "rows_screened",
              "rows_reranked", "bytes_gathered", "tables_probed", "stop_reason"):
        got, want = getattr(trep, f), getattr(jrep, f)
        assert (got is None) == (want is None), f
        if got is not None:
            assert isinstance(got, np.ndarray) and np.array_equal(got, np.asarray(want)), f
    for f in ("quality", "provenance", "plan_build_s", "storage", "table_bytes"):
        assert getattr(trep, f) == getattr(jrep, f), f
    if spec.get("mode") != "exact":
        assert (trep.truncated_tables > 0).any(), "degenerate: no window truncated"
    got_d, want_d = trep.to_dict(), jrep.to_dict()
    assert got_d.keys() == want_d.keys()
    for key in got_d:
        if key == "spec":  # the reference's QuerySpec has no more fields than the port's
            assert got_d[key] == {f: want_d[key][f] for f in got_d[key]}
        elif isinstance(got_d[key], float):
            assert got_d[key] == pytest.approx(want_d[key], rel=1e-5), key
        else:
            assert got_d[key] == want_d[key], key


def test_explain_resolves_a_quality_spec():
    """Quality-first planning is ported (Queue A item 10): explain resolves
    a QualitySpec to its plan and reports the quality and its provenance."""
    _, tidx = _cached_pair("theta", "sealed", "f32")
    quality = tapi.QualitySpec(k=3, calibration_queries=8)
    q, w = np.zeros((2, D), np.float32), np.ones((2, D), np.float32)
    try:
        rep = tidx.explain(q, w, quality)
        assert rep.quality == quality and rep.spec == tidx.plans[quality]
        assert rep.provenance == "calibrated" and rep.plan_build_s > 0
        assert torch.equal(rep.result.ids, tidx.query(q, w, rep.spec).ids)
    finally:
        tidx.plans.clear()
        tidx.plan_times.clear()
