"""Port parity of quality-first planning (CPU): ``PlannedSpec``, ``Planner``
and ``Index`` with a ``QualitySpec``.

The reference draws its planning samples with ``jax.random``, which torch
cannot replay, so these tests record the reference planner's samples
(``Planner._sample``) and hand them, in call order, to the port's
``Planner._sample``; indexes are built by the JAX package and carried
across with ``Index.from_numpy``. Everything downstream must then match:

* ``plan_config``: K, L, the window and the space equal, W within rtol
  1e-6 (theta, l2 and auto; three seeds);
* the calibrated ladder: the same rungs, the same recall, ``mean_cand`` and
  ``cost`` within rtol 1e-6, the Thm 1 ``predicted_success`` within rtol
  1e-6 (f32 theory on exact-scan distances that may differ by an ulp), the
  same choice, the same ``plan_ladder`` and the same warnings (f32, l2,
  int8 with its screened rungs, mutable);
* a planned query returns the reference's ids (dists within rtol/atol 1e-5);
* a quality build with the reference's tables handed over derives the
  reference's geometry and plan through the same escalation.

The port's own builds are checked for ``query(quality) == query(plan)``
bit for bit, deterministic escalation from an int and a
``torch.Generator``, the memo's lifecycle and ``explain``. The
``QuerySpec(impl=...)`` projections are held against the reference's two
plain formulations. Bar for answers: tests/test_kernels_topk.py's.
"""

import dataclasses
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
import repro_torch.core.hash_families as thf
from repro.api import planner as jplanner
from repro.core.transforms import BoundedSpace as JSpace
from repro_torch.api import index as tindex
from repro_torch.api import planner as tplanner
from repro_torch.core.index import index_from_numpy
from repro_torch.core.transforms import BoundedSpace as TSpace

N, D, M, B, TOPK = 600, 8, 8, 12, 5
QUALITY = dict(k=TOPK, recall_target=0.8, calibration_queries=16)
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small torch ops: one intra-op thread keeps them
    from oversubscribing the CPU when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qualities(**over):
    kw = QUALITY | over
    return japi.QualitySpec(**kw), tapi.QualitySpec(**kw)


def _configs(family="theta", storage="f32", **over):
    kw = dict(d=D, M=M, K=6, L=12, family=family, W=16.0, max_candidates=64,
              storage=storage) | over
    return (japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw),
            tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw))


def _data(seed, n=N):
    return np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n, D)))


def _queries(seed=11):
    rs = np.random.default_rng(seed)
    q = rs.uniform(0, 1, (B, D)).astype(np.float32)
    w = (np.abs(rs.normal(size=(B, D))) + 0.2).astype(np.float32)
    return q, w


def _leaves(jindex):
    """The reference index's leaves as numpy arrays, as ``from_numpy`` takes them."""
    s = jindex.state
    out = {
        "folded": np.asarray(s.tables.folded), "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers), "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm), "data": np.asarray(s.data), "levels": np.asarray(s.levels),
        "scales": None if s.scales is None else np.asarray(s.scales),
    }
    if jindex.mutable:
        out.update(delta_data=np.asarray(jindex.delta.data),
                   delta_levels=np.asarray(jindex.delta.levels),
                   delta_keys=np.asarray(jindex.delta.keys),
                   delta_fill=np.asarray(jindex.delta.fill),
                   tombstones=np.asarray(jindex.tombstones))
    return out


class Handover:
    """Record the reference planner's samples and hand them to the port's
    planner in the same order (install with :meth:`patch`)."""

    def __init__(self):
        self.samples = []

    def patch(self, mp):
        orig = jplanner.Planner._sample
        samples = self.samples

        def record(planner, key, data, m, jitter):
            qs, ws = orig(planner, key, data, m, jitter)
            samples.append((np.asarray(qs), np.asarray(ws)))
            return qs, ws

        def hand(planner, generator, data, m, jitter):
            qs, ws = samples.pop(0)
            return torch.from_numpy(qs).to(data.device), torch.from_numpy(ws).to(data.device)

        mp.setattr(jplanner.Planner, "_sample", record)
        mp.setattr(tplanner.Planner, "_sample", hand)
        return self


def _fields(plan, skip=()):
    """A PlannedSpec's fields with NaN as None (NaN != NaN)."""
    return {k: (None if isinstance(v, float) and math.isnan(v) else v)
            for k, v in dataclasses.asdict(plan).items() if k not in skip}


def _assert_plan_equal(got, want):
    """Equal but ``predicted_success`` (rtol 1e-6: f32 theory)."""
    assert type(got).__name__ == "PlannedSpec"
    assert _fields(got, ("predicted_success",)) == _fields(want, ("predicted_success",))
    np.testing.assert_allclose(got.predicted_success, want.predicted_success, rtol=RTOL)


def _assert_answer(tres, jres):
    assert np.array_equal(tres.ids.numpy(), np.asarray(jres.ids))
    np.testing.assert_allclose(tres.dists.numpy(), np.asarray(jres.dists), rtol=1e-5, atol=1e-5)
    assert np.array_equal(tres.n_candidates.numpy(), np.asarray(jres.n_candidates))


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

BAD_SPECS = [
    ("QualitySpec", dict(k=0)),
    ("QualitySpec", dict(recall_target=0.0)),
    ("QualitySpec", dict(approx_c=1.0)),
    ("QualitySpec", dict(fail_prob=1.0)),
    ("QualitySpec", dict(latency_budget_ms=0.0)),
    ("QualitySpec", dict(calibration_queries=0)),
    ("PlannedSpec", dict(k=5, mode="exact")),
    ("PlannedSpec", dict(k=5, mode="probe", screen_alpha=0.5)),
    ("PlannedSpec", dict(k=5, mode="probe", provenance="guessed")),
    ("PlannedSpec", dict(k=0, mode="probe")),
    ("PlannedSpec", dict(k=5, mode="multiprobe", n_probes=0)),
    ("PlannedSpec", dict(k=5, mode="probe", max_candidates=0)),
    ("PlannedSpec", dict(k=5, mode="multiprobe", max_flips=-1)),
    ("PlannedSpec", dict(k=5, mode="probe", early_exit=1)),
    ("PlannedSpec", dict(k=5, mode="probe", exit_group=0)),
    ("PlannedSpec", dict(k=5, mode="probe", exit_slack=1.0)),
    ("QuerySpec", dict(impl="pallas")),
    ("QuerySpec", dict(impl="gather", mode="multiprobe")),
]


@pytest.mark.parametrize("cls,kwargs", BAD_SPECS)
def test_spec_validation_messages_equal(cls, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(japi, cls)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(tapi, cls)(**kwargs)
    assert str(got.value) == str(want.value)


def test_plannedspec_conversion_matches_reference():
    kw = dict(k=5, mode="multiprobe", n_probes=4, max_flips=2, max_candidates=32,
              screen_alpha=2.0, early_exit=True, exit_group=4, exit_slack=0.1)
    for mode in ("multiprobe", "probe"):
        jp, tp = japi.PlannedSpec(**(kw | {"mode": mode})), tapi.PlannedSpec(**(kw | {"mode": mode}))
        assert dataclasses.asdict(tp.to_query_spec()) == dataclasses.asdict(jp.to_query_spec())
        assert _fields(tp) == _fields(jp)
    _, cfg = _configs(max_candidates=64)
    assert tapi.PlannedSpec(k=5, mode="probe", max_candidates=32).effective_config(
        cfg).max_candidates == 32
    assert tapi.PlannedSpec(k=5, mode="probe", max_candidates=64).effective_config(cfg) is cfg
    with pytest.raises(ValueError, match="exceeds the built"):
        tapi.PlannedSpec(k=5, mode="probe", max_candidates=128).effective_config(cfg)
    assert hash(tapi.QualitySpec()) == hash(tapi.QualitySpec())


def test_query_rejects_unknown_specs_and_unreachable_planned_probes():
    jcfg, tcfg = _configs(K=4)
    tidx = tapi.Index.build(0, _data(0), tcfg, device="cpu")
    q, w = (torch.from_numpy(a) for a in _queries())
    with pytest.raises(TypeError, match="spec must be a QuerySpec, QualitySpec, or PlannedSpec"):
        tidx.query(q, w, {"k": 3})
    # K=4, max_flips=1 reaches 1 + 4 = 5 keys; the gate holds for plans too
    tidx.query(q, w, tapi.PlannedSpec(k=3, mode="multiprobe", n_probes=5, max_flips=1))
    with pytest.raises(ValueError, match="distinct probe keys reachable"):
        tidx.query(q, w, tapi.PlannedSpec(k=3, mode="multiprobe", n_probes=6, max_flips=1))


# ---------------------------------------------------------------------------
# precision helpers and the build-time solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 16, 64, 65])
def test_median_and_quantile_bit_equal_jnp(n):
    """``torch.median`` takes the lower middle value; ``jnp.median`` the
    midpoint. The port's helpers return jnp's f32 bits."""
    rs = np.random.default_rng(n)
    for _ in range(20):
        x = (rs.lognormal(size=n) * rs.uniform(1, 1000)).astype(np.float32)
        assert float(tplanner.median_f32(torch.from_numpy(x))) == float(jnp.median(x))
        for q in (0.25, 0.75):
            assert float(tplanner.quantile_f32(torch.from_numpy(x), q)) == float(
                jnp.quantile(jnp.asarray(x), q))
    ints = rs.integers(0, 5000, (n,), dtype=np.int32)
    assert tplanner.mean_f32(torch.from_numpy(ints)) == float(jnp.mean(jnp.asarray(ints)))


PLAN_CONFIG_CASES = [(fam, seed) for fam in ("theta", "l2", "auto") for seed in (0, 1, 3)]


@pytest.mark.parametrize("family,seed", PLAN_CONFIG_CASES)
def test_plan_config_matches_reference(family, seed):
    data = _data(seed)
    jq, tq = _qualities(seed=seed)
    with pytest.MonkeyPatch.context() as mp:
        Handover().patch(mp)
        want = japi.Planner().plan_config(jnp.asarray(data), jq, family=family)
        got = tapi.Planner().plan_config(torch.from_numpy(data), tq, family=family)
    assert (got.family, got.K, got.L, got.max_candidates, got.M, got.d, got.storage) == (
        want.family, want.K, want.L, want.max_candidates, want.M, want.d, want.storage)
    assert tuple(got.space) == tuple(want.space)
    np.testing.assert_allclose(got.W, want.W, rtol=RTOL)


def test_plan_config_degenerate_raises_in_both():
    """Seed 2 gives the l2 family no usable collision probabilities."""
    data = _data(2)
    jq, tq = _qualities(seed=2)
    with pytest.MonkeyPatch.context() as mp:
        Handover().patch(mp)
        with pytest.raises(ValueError) as want:
            japi.Planner().plan_config(jnp.asarray(data), jq, family="l2")
        with pytest.raises(ValueError) as got:
            tapi.Planner().plan_config(torch.from_numpy(data), tq, family="l2")
    assert str(got.value) == str(want.value)


def _clustered(n=2048, d=128, seed=0):
    """The SERVICE workload's recipe (portbench's ``clusters``) at a
    small n: clusters of 16 rows around centres uniform in [0.1, 0.9]^d,
    jitter 1e-3; and its query weights, 64 rows of 1 + 0.1·|N(0, 1)|."""
    rs = np.random.default_rng(seed)
    centres = rs.uniform(0.1, 0.9, (n // 16, d))
    data = (centres[:, None, :] + 1e-3 * rs.normal(size=(n // 16, 16, d))).reshape(-1, d)
    w = 1.0 + 0.1 * np.abs(rs.normal(size=(64, d)))
    return data.astype(np.float32), w.astype(np.float32)


# (family, calibration weights, QualitySpec seed, whether the solve is degenerate)
CLUSTERED_CASES = [("l2", "default", 0, True), ("l2", "default", 1, True),
                   ("theta", "default", 0, False), ("theta", "default", 1, False),
                   ("l2", "workload", 0, False), ("theta", "workload", 0, False)]


@pytest.mark.parametrize("family,weights,seed,degenerate", CLUSTERED_CASES)
def test_plan_config_on_the_clustered_service_data(family, weights, seed, degenerate):
    """At d=128 on the SERVICE workload's clusters, with the reference's
    sample handed over: under the default weights |N(0,1)| + 0.1 the l2
    solve finds no usable collision probabilities in both packages (the
    same ValueError) while theta plans; under the workload's own weights
    both families plan, alike in both packages."""
    data, w = _clustered()
    jq, tq = _qualities(k=10, recall_target=0.9, calibration_queries=64, seed=seed)
    jw, tw = (None, None) if weights == "default" else (jnp.asarray(w), torch.from_numpy(w))
    with pytest.MonkeyPatch.context() as mp:
        Handover().patch(mp)
        if degenerate:
            with pytest.raises(ValueError, match="no hash family yields usable") as want:
                japi.Planner(weights=jw).plan_config(jnp.asarray(data), jq, family=family)
            with pytest.raises(ValueError) as got:
                tapi.Planner(weights=tw).plan_config(torch.from_numpy(data), tq, family=family)
            assert str(got.value) == str(want.value)
            return
        want = japi.Planner(weights=jw).plan_config(jnp.asarray(data), jq, family=family)
        got = tapi.Planner(weights=tw).plan_config(torch.from_numpy(data), tq, family=family)
    assert (got.family, got.K, got.L, got.max_candidates) == (
        want.family, want.K, want.L, want.max_candidates)
    assert tuple(got.space) == tuple(want.space)
    # l2's W comes from Eq 24, sqrt(M (d + sum w^2) - 2 (M sum w - r)): at
    # d=128 two ~9e3 terms cancel to ~1e2, so the one-ulp difference that
    # torch's and XLA's orders of a 128-term f32 sum may leave moves W by a
    # few 1e-6 (theta's W is the constant 4.0)
    np.testing.assert_allclose(got.W, want.W, rtol=1e-5)


@pytest.mark.parametrize("family", ["theta", "l2"])
@pytest.mark.parametrize("scale", [0.5, 3.0, 12.0])
def test_solve_family_and_solve_L_match_reference(family, scale):
    """The same radii and weights: K and L equal, W, P1, P2 and rho within
    rtol 1e-6; and ``_solve_L`` equal on the same success samples."""
    rs = np.random.default_rng(int(scale * 10))
    r1 = (rs.uniform(0.5, 1.5, 32) * scale).astype(np.float32)
    ws = (np.abs(rs.normal(size=(32, D))) + 0.1).astype(np.float32)
    jq, tq = _qualities()
    want = japi.Planner()._solve_family(family, jnp.asarray(r1), 2.0 * jnp.asarray(r1), M, D,
                                        jnp.asarray(ws), N, jq)
    got = tapi.Planner()._solve_family(family, torch.from_numpy(r1), 2.0 * torch.from_numpy(r1),
                                       M, D, torch.from_numpy(ws), N, tq)
    assert (got is None) == (want is None)
    if want is not None:
        assert (got["family"], got["K"], got["L"]) == (want["family"], want["K"], want["L"])
        for key in ("W", "P1", "P2", "rho"):
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    p1 = np.clip(rs.uniform(0.3, 0.999, 64), 1e-9, 1 - 1e-9)
    for K in (1, 4, 9, 20):
        for goal in (0.5, 0.9, 0.99):
            assert tapi.Planner()._solve_L(p1, K, goal) == japi.Planner()._solve_L(p1, K, goal)


# ---------------------------------------------------------------------------
# the calibrated ladder on a reference-built index
# ---------------------------------------------------------------------------

LADDER_CASES = {
    "theta-f32": dict(family="theta", storage="f32"),
    "l2-f32": dict(family="l2", storage="f32", K=4),
    "theta-int8": dict(family="theta", storage="int8"),
    "theta-mutable": dict(family="theta", storage="f32", mutable=True),
}
_PAIRS = {}


def _pair(case):
    """(reference index, port index) for a ladder case."""
    if case not in _PAIRS:
        kw = dict(LADDER_CASES[case])
        mutable = kw.pop("mutable", False)
        jcfg, tcfg = _configs(**kw)
        data = _data(1)
        cap = 64 if mutable else 0
        jidx = japi.Index.build(jax.random.PRNGKey(3), data, jcfg,
                                update=japi.UpdateSpec(delta_capacity=cap))
        if mutable:
            jidx, ids = jidx.insert(_data(4, n=40))
            jidx = jidx.delete(jnp.asarray([0, 7, 19, int(ids[2]), int(ids[30])], jnp.int32))
        tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg,
                                     update=tapi.UpdateSpec(delta_capacity=cap), device="cpu")
        _PAIRS[case] = (jidx, tidx)
    return _PAIRS[case]


_CALIBRATIONS = {}


def _calibrations(case, **quality):
    """Both packages' ``_calibrate`` on the case's index, the sample handed over."""
    key = (case, tuple(sorted(quality.items())))
    if key not in _CALIBRATIONS:
        jidx, tidx = _pair(case)
        jq, tq = _qualities(**quality)
        with pytest.MonkeyPatch.context() as mp:
            Handover().patch(mp)
            want = japi.Planner()._calibrate(jidx, jq)
            got = tapi.Planner()._calibrate(tidx, tq)
        _CALIBRATIONS[key] = got, want
    return _CALIBRATIONS[key]


@pytest.mark.parametrize("case", list(LADDER_CASES))
def test_calibrated_ladder_matches_reference(case):
    (got, got_success), (want, want_success) = _calibrations(case)
    np.testing.assert_allclose(got_success, want_success, rtol=RTOL)
    assert len(got) == len(want)
    for (g_rung, g_rec, g_cand, g_cost), (w_rung, w_rec, w_cand, w_cost) in zip(got, want):
        assert _fields(g_rung) == _fields(w_rung)  # expected_tables stamped, never NaN
        assert not math.isnan(g_rung.expected_tables)
        assert g_rec == w_rec
        np.testing.assert_allclose(g_cand, w_cand, rtol=RTOL)
        np.testing.assert_allclose(g_cost, w_cost, rtol=RTOL)
    if LADDER_CASES[case]["storage"] != "f32":
        assert any(r.screen_alpha for r, *_ in got)  # the screened rungs ran


def _select(planner, scored, quality):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chosen = planner._select(scored, quality)
    return chosen, [str(w.message) for w in caught]


@pytest.mark.parametrize("budget", [None, 0.001])
@pytest.mark.parametrize("case", list(LADDER_CASES))
def test_choice_and_warnings_match_reference(case, budget):
    """The same rung wins, with the same best-effort or budget warning."""
    (got, got_success), (want, want_success) = _calibrations(case)
    jq, tq = _qualities(latency_budget_ms=budget)
    g, g_warn = _select(tapi.Planner(), got, tq)
    w, w_warn = _select(japi.Planner(), want, jq)
    assert got.index(g) == want.index(w)
    assert g_warn == w_warn
    _assert_plan_equal(tapi.Planner._stamp(g, got_success), japi.Planner._stamp(w, want_success))


@pytest.mark.parametrize("case", ["theta-f32", "l2-f32", "theta-int8"])
def test_plan_query_and_ladder_match_reference(case):
    jidx, tidx = _pair(case)
    jq, tq = _qualities()
    with pytest.MonkeyPatch.context() as mp:
        Handover().patch(mp)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            want_plan = japi.Planner().plan_query(jidx, jq)
            want_ladder = japi.Planner().plan_ladder(jidx, jq)
            want_warn = [str(w.message) for w in caught]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got_plan = tapi.Planner().plan_query(tidx, tq)
            got_ladder = tapi.Planner().plan_ladder(tidx, tq)
            got_warn = [str(w.message) for w in caught]
    _assert_plan_equal(got_plan, want_plan)
    assert len(got_ladder) == len(want_ladder)
    for g, w in zip(got_ladder, want_ladder):
        _assert_plan_equal(g, w)
    assert got_warn == want_warn
    costs = [tapi.Planner()._plan_cost(tidx.config, p, p.expected_candidates) for p in got_ladder]
    assert all(a > b for a, b in zip(costs, costs[1:]))  # strictly cheaper down the ladder


@pytest.mark.parametrize("case", ["theta-f32", "l2-f32", "theta-int8", "theta-mutable"])
def test_planned_query_matches_reference(case):
    """Under the reference's chosen plan the port returns the reference's
    ids, and ``query(quality)`` equals ``query(plan)`` bit for bit."""
    jidx, tidx = _pair(case)
    (got, got_success), (want, want_success) = _calibrations(case)
    jq, tq = _qualities()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jplan = japi.Planner._stamp(japi.Planner()._select(want, jq), want_success)
    tplan = tapi.PlannedSpec(**dataclasses.asdict(jplan))
    q, w = _queries()
    tq_, tw = torch.from_numpy(q), torch.from_numpy(w)
    _assert_answer(tidx.query(tq_, tw, tplan), jidx.query(q, w, jplan))
    tidx.plans[tq] = tplan  # the memo answers the QualitySpec
    try:
        a, b = tidx.query(tq_, tw, tq), tidx.query(tq_, tw, tplan)
        for f in ("ids", "dists", "n_candidates"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    finally:
        tidx.plans.pop(tq)


# ---------------------------------------------------------------------------
# quality builds
# ---------------------------------------------------------------------------


class CountingPlanner(tapi.Planner):
    """Records the geometry of every calibrated attempt."""

    def plan_query(self, index, quality):
        self.__dict__.setdefault("attempts", []).append(index.config)
        return super().plan_query(index, quality)


class StarvedPlanner(CountingPlanner):
    """Starts from two tables and offers only the narrowest single-probe
    rung, so a high target is missed and the build escalates."""

    def plan_config(self, *args, **kwargs):
        return dataclasses.replace(super().plan_config(*args, **kwargs), L=2)

    def _plan_ladder(self, cfg, k, exit_slack=0.0):
        return super()._plan_ladder(cfg, k, exit_slack)[:1]


@pytest.mark.parametrize("family", ["theta", "auto"])
def test_quality_build_matches_reference_with_tables_handed_over(family):
    """The whole slice: with the reference's tables (built from the
    reference's key for each attempt's geometry) and its samples handed
    over, the port's quality build derives the reference's geometry through
    the same attempts and memoizes the reference's plan."""
    data = _data(5)
    key = jax.random.PRNGKey(21)
    jq, tq = _qualities(recall_target=0.97)

    def tables_from_reference(gen, data_t, cfg):
        jcfg = japi.IndexConfig(d=cfg.d, M=cfg.M, K=cfg.K, L=cfg.L, family=cfg.family, W=cfg.W,
                                max_candidates=cfg.max_candidates, space=JSpace(*cfg.space),
                                storage=cfg.storage)
        jidx = japi.Index.build(key, data, jcfg)
        return index_from_numpy(_leaves(jidx), cfg, data_t.device)

    attempts = []
    orig = jplanner.Planner.plan_query

    def count(planner, index, quality):
        attempts.append(index.config.L)
        return orig(planner, index, quality)

    planner = CountingPlanner()
    with pytest.MonkeyPatch.context() as mp:
        Handover().patch(mp)
        mp.setattr(jplanner.Planner, "plan_query", count)
        mp.setattr(tindex, "build_index", tables_from_reference)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            jidx = japi.Index.build(key, data, jq, family=family)
            want_warn = [str(w.message) for w in caught]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tidx = tapi.Index.build(0, data, tq, family=family, planner=planner, device="cpu")
            got_warn = [str(w.message) for w in caught]
    assert [c.L for c in planner.attempts] == attempts
    jc, tc = jidx.config, tidx.config
    assert (tc.family, tc.K, tc.L, tc.max_candidates, tuple(tc.space)) == (
        jc.family, jc.K, jc.L, jc.max_candidates, tuple(jc.space))
    np.testing.assert_allclose(tc.W, jc.W, rtol=RTOL)
    _assert_plan_equal(tidx.plans[tq], jidx.plans[jq])
    assert got_warn == want_warn


@pytest.mark.parametrize("seed_kind", ["int", "generator"])
def test_quality_build_escalates_from_the_same_generator_state(seed_kind):
    """A target the first geometry misses doubles L; every attempt starts
    from the same generator state, so the escalated index is the one a
    fresh build with its config gives (from an int or a Generator)."""
    data = torch.from_numpy(_data(6))
    _, tq = _qualities(recall_target=0.999)
    planner = StarvedPlanner()
    seed = 7 if seed_kind == "int" else torch.Generator().manual_seed(7)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tidx = tapi.Index.build(seed, data, tq, family="theta", planner=planner, device="cpu")
    Ls = [c.L for c in planner.attempts]
    assert len(Ls) == 3 and Ls[1] == min(2 * Ls[0], planner.max_L) and Ls[2] == min(
        2 * Ls[1], planner.max_L)
    plan = tidx.plans[tq]
    assert plan.predicted_recall < tq.recall_target
    assert any("no execution plan reaches recall_target" in str(w.message) for w in caught)
    fresh = tapi.Index.build(7, data, tidx.config, device="cpu")
    for f in ("sorted_keys", "perm", "mixers", "levels"):
        assert torch.equal(getattr(fresh.state, f), getattr(tidx.state, f)), f
    assert torch.equal(fresh.state.tables.folded, tidx.state.tables.folded)
    assert tidx.plan_times[tq] > 0


@pytest.fixture(scope="module")
def planned():
    """A port-built quality index (f32, mutable)."""
    _, tq = _qualities()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tidx = tapi.Index.build(9, torch.from_numpy(_data(8)), tq, device="cpu",
                                update=tapi.UpdateSpec(delta_capacity=32))
    return tidx, tq


def test_quality_query_bit_identical_to_planned(planned):
    tidx, tq = planned
    q, w = (torch.from_numpy(a) for a in _queries())
    plan = tidx.plan(tq)
    assert tidx.plans[tq] is plan and tidx.plan(tq) is plan  # memoized
    a, b = tidx.query(q, w, tq), tidx.query(q, w, plan)
    knob = tidx.query(q, w, dataclasses.replace(plan, predicted_recall=float("nan"),
                                                predicted_success=float("nan")))
    for f in ("ids", "dists", "n_candidates"):
        assert torch.equal(getattr(a, f), getattr(b, f)) and torch.equal(getattr(a, f),
                                                                         getattr(knob, f))
    assert plan.max_candidates <= tidx.config.max_candidates
    assert 0.0 <= plan.predicted_recall <= 1.0 and 0.0 <= plan.predicted_success <= 1.0


def test_plan_ladder_and_explain(planned):
    tidx, tq = planned
    q, w = (torch.from_numpy(a) for a in _queries())
    ladder = tidx.plan_ladder(tq)
    assert tidx.plan_ladder(tq) is ladder and ladder[0] == tidx.plan(tq)
    rep = tidx.explain(q, w, tq)
    assert rep.quality == tq and rep.spec == tidx.plan(tq)
    assert rep.provenance == "calibrated" and rep.plan_build_s > 0
    assert torch.equal(rep.result.ids, tidx.query(q, w, tq).ids)
    assert rep.to_dict()["quality"]["recall_target"] == tq.recall_target
    raw = tidx.explain(q, w, tapi.QuerySpec(k=3))
    assert raw.quality is None and raw.provenance is None and raw.plan_build_s is None


def test_plan_memo_follows_the_lifecycle(planned):
    """insert/delete share the memos; compact drops them (the reference's
    lifecycle)."""
    tidx, tq = planned
    plan = tidx.plan(tq)
    grown, _ = tidx.insert(torch.from_numpy(_data(10, n=8)))
    shrunk = grown.delete(torch.arange(3))
    for derived in (grown, shrunk):
        assert derived.plans is tidx.plans and derived.plan(tq) is plan
        assert derived.plan_times is tidx.plan_times and derived.ladders is tidx.ladders
    compacted = shrunk.compact()
    assert compacted.plans == {} and compacted.ladders == {} and compacted.tuning is None


def test_build_is_deterministic_and_reproducible_from_a_seed(planned):
    tidx, tq = planned
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = tapi.Index.build(9, torch.from_numpy(_data(8)), tq, device="cpu",
                                 update=tapi.UpdateSpec(delta_capacity=32))
    assert again.config == tidx.config and again.plans[tq] == tidx.plans[tq]
    other = dataclasses.replace(tq, seed=4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert again.plan(other) == tidx.plan(other)


# ---------------------------------------------------------------------------
# QuerySpec(impl=...)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("weighted", [False, True])
def test_impl_projection_matches_reference(impl, weighted):
    jidx, tidx = _pair("theta-f32")
    rs = np.random.default_rng(4)
    levels = rs.integers(0, M + 1, (9, D)).astype(np.int32)
    w = (np.abs(rs.normal(size=(9, D))) + 0.1).astype(np.float32) if weighted else None
    tables = jidx.state.tables
    want = (jhf._project_onehot if impl == "onehot" else jhf._project_gather)(
        jnp.asarray(levels), tables.folded, None if w is None else jnp.asarray(w))
    got = thf.project_query(torch.from_numpy(levels),
                            None if w is None else torch.from_numpy(w),
                            tidx.state.tables, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if weighted:
        auto = thf.project_query(torch.from_numpy(levels), torch.from_numpy(w),
                                 tidx.state.tables)
        via = thf.project_query(torch.from_numpy(levels), torch.from_numpy(w),
                                tidx.state.tables, impl=impl)
        np.testing.assert_allclose(via.numpy(), auto.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("impl", ["gather", "onehot"])
@pytest.mark.parametrize("case", ["theta-f32", "l2-f32"])
def test_impl_query_matches_reference(case, impl):
    jidx, tidx = _pair(case)
    q, w = _queries()
    spec = dict(k=TOPK, impl=impl)
    _assert_answer(tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(**spec)),
                   jidx.query(q, w, japi.QuerySpec(**spec)))


def test_impl_refuses_tensors_off_the_cpu():
    """Off the CPU (here the meta device; on the card the same check) a
    plain projection raises instead of running."""
    levels = torch.zeros((2, D), dtype=torch.int32, device="meta")
    w = torch.ones((2, D), device="meta")
    folded = torch.zeros((4, D, M + 1), device="meta")
    tables = thf.PrefixTables(folded=folded, offsets=torch.zeros((4,), device="meta"))
    for impl in ("gather", "onehot"):
        with pytest.raises(ValueError, match="runs on CPU tensors only"):
            thf.project_query(levels, w, tables, impl=impl)
