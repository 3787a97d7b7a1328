"""Port parity of the serving tier (CPU): ``repro_torch.serving`` against
``repro.serving`` at the reference tests' size (N=512, d=8, k=5).

* the arrival traces, ``merge_topk_host`` and ``shard_row_ranges`` (and
  their ``ValueError``s) equal the reference's bit for bit;
* ``StragglerMonitor``, ``LatencyTracker`` and ``DegradationController``
  give the reference's sequences on a fed latency series;
* a reference-built index is handed over through its saved directory
  (``Index.load(device="cpu")``, f32 and int8); its ``ShardSet`` answers
  exact and planned queries as the reference's does (ids equal, dists
  within rtol/atol 1e-5, coverage equal);
* ``Broker.run`` with an injected ``service_time_fn`` (virtual time) in the
  reference tests' overload, shed and chaos cases returns the reference's
  responses field by field (dists within 1e-5, ``predicted_success``
  within rtol 1e-6), stats, recovery log and backoffs. The planner's
  calibration sample is handed over as in ``test_torch_planner.py``;
* the rebuild guard raises ``RetraceError`` when a kernel library is built
  or loaded after warmup;
* ``serve --mode broker --device cpu`` runs, with and without a chaos kill.
"""

import dataclasses
import math
import warnings

import jax
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.serving as jserving
import repro_torch.api as tapi
import repro_torch.serving as tserving
from repro.api import planner as jplanner
from repro.core import distributed as jdist
from repro.runtime import fault as jfault
from repro_torch.analysis import RetraceError, RetraceGuard
from repro_torch.api import planner as tplanner
from repro_torch.core import distributed as tdist
from repro_torch.kernels import _build
from repro_torch.runtime import fault as tfault

N, D, K = 512, 8, 5
RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops: one intra-op thread keeps them from
    oversubscribing the CPU when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Handover:
    """Record the reference planner's calibration samples and hand them to
    the port's planner in the same order (jax.random cannot be replayed)."""

    def __init__(self, mp):
        samples = []
        orig = jplanner.Planner._sample

        def record(planner, key, data, m, jitter):
            qs, ws = orig(planner, key, data, m, jitter)
            samples.append((np.array(qs), np.array(ws)))
            return qs, ws

        def hand(planner, generator, data, m, jitter):
            qs, ws = samples.pop(0)
            return torch.from_numpy(qs).to(data.device), torch.from_numpy(ws).to(data.device)

        mp.setattr(jplanner.Planner, "_sample", record)
        mp.setattr(tplanner.Planner, "_sample", hand)


def _fields(plan, skip=("predicted_success",)):
    return {k: (None if isinstance(v, float) and math.isnan(v) else v)
            for k, v in dataclasses.asdict(plan).items() if k not in skip}


def _assert_plan_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "PlannedSpec"
    assert _fields(got) == _fields(want)
    np.testing.assert_allclose(got.predicted_success, want.predicted_success, rtol=RTOL)


def _handed_over(jidx, tmp_path):
    """The reference index as the port loads it from the reference's own
    directory (config, build_key, plans and every leaf), on the CPU."""
    jidx.save(str(tmp_path))
    return tapi.Index.load(tmp_path, device="cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tests/test_serving.py's index (normal rows, QualitySpec(k=5, 0.8))
    in both packages, with both ladders resolved on one handed-over sample."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(N, D)).astype(np.float32)
    jq = japi.QualitySpec(k=K, recall_target=0.8)
    tq = tapi.QualitySpec(k=K, recall_target=0.8)
    jidx = japi.Index.build(jax.random.PRNGKey(0), data, jq)
    tidx = _handed_over(jidx, tmp_path_factory.mktemp("ref") / "index")
    with pytest.MonkeyPatch.context() as mp:
        Handover(mp)
        jladder = jidx.plan_ladder(jq)
        tladder = tidx.plan_ladder(tq)
    return jidx, jq, jladder, tidx, tq, tladder


@pytest.fixture(scope="module")
def qw():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, D)).astype(np.float32)
    w = np.abs(rng.normal(size=(64, D))).astype(np.float32) + 0.1
    return q, w


# --- numpy pieces: bit for bit ----------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_traces_equal_reference(seed):
    for rate, n in ((100.0, 50), (3000.0, 2000)):
        np.testing.assert_array_equal(tserving.poisson_trace(rate, n, seed=seed, t0=0.25),
                                      jserving.poisson_trace(rate, n, seed=seed, t0=0.25))
        np.testing.assert_array_equal(
            tserving.bursty_trace(rate / 2, rate * 4, n, seed=seed, period_s=0.05, duty=0.3),
            jserving.bursty_trace(rate / 2, rate * 4, n, seed=seed, period_s=0.05, duty=0.3))
        for kind in ("poisson", "bursty"):
            np.testing.assert_array_equal(tserving.make_trace(kind, rate, n, seed=seed),
                                          jserving.make_trace(kind, rate, n, seed=seed))


@pytest.mark.parametrize("call", [
    lambda m: m.poisson_trace(0.0, 5),
    lambda m: m.bursty_trace(100.0, 10.0, 5),
    lambda m: m.bursty_trace(10.0, 100.0, 5, duty=0.0),
    lambda m: m.make_trace("uniform", 10.0, 5),
], ids=["rate", "burst", "duty", "kind"])
def test_trace_errors_equal_reference(call):
    with pytest.raises(ValueError) as want:
        call(jserving)
    with pytest.raises(ValueError) as got:
        call(tserving)
    assert str(got.value) == str(want.value)


def test_shard_row_ranges_equal_reference():
    for n, s in ((8, 2), (512, 4), (262144, 4), (7, 7)):
        assert tdist.shard_row_ranges(n, s) == jdist.shard_row_ranges(n, s)
    for n, s in ((10, 4), (8, 0), (8, -2)):
        with pytest.raises(ValueError) as want:
            jdist.shard_row_ranges(n, s)
        with pytest.raises(ValueError) as got:
            tdist.shard_row_ranges(n, s)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", range(4))
def test_merge_topk_host_equal_reference(seed):
    """Random per-shard blocks with dead shards, sentinel tails and ties at
    equal distance (small integer distances): bit for bit, dtypes too."""
    rs = np.random.default_rng(seed)
    S, b, kk, k = 4, 6, 5, 7
    dists = np.sort(rs.integers(0, 4, (S, b, kk)).astype(np.float64), axis=2)
    ids = rs.integers(0, 1000, (S, b, kk)).astype(np.int64)
    tail = rs.random((S, b, kk)) < 0.3
    tail = np.cumsum(tail, axis=2) > 0  # sentinels only at the end of a block
    dists[tail], ids[tail] = np.inf, -1
    dists[seed % S], ids[seed % S] = np.inf, -1  # a dead shard
    td, ti = tdist.merge_topk_host(dists, ids, k)
    jd, ji = jdist.merge_topk_host(dists, ids, k)
    assert td.dtype == jd.dtype and ti.dtype == ji.dtype
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ti, ji)
    # the reference test's case: sentinels sink, ties break stably
    d = np.array([[[0.5, np.inf]], [[np.inf, np.inf]], [[0.2, 0.7]]])
    i = np.array([[[3, -1]], [[-1, -1]], [[10, 11]]])
    md, mi = tdist.merge_topk_host(d, i, 3)
    np.testing.assert_array_equal(mi[0], [10, 3, 11])
    np.testing.assert_allclose(md[0], [0.2, 0.5, 0.7])


# --- SLO machinery: equal sequences -----------------------------------------


def _latencies(seed=3, n=400):
    rs = np.random.default_rng(seed)
    base = rs.gamma(2.0, 5.0, n)
    base[100:180] *= 8.0  # an overload episode, then a calm tail
    base[200:] *= 0.3
    base[300:310] = 0.0
    return base.tolist()


def test_straggler_monitor_equal_reference():
    for k_sigma in (3.0, math.inf):
        t, j = tfault.StragglerMonitor(k_sigma=k_sigma), jfault.StragglerMonitor(k_sigma=k_sigma)
        got = [t.observe(i, x) for i, x in enumerate(_latencies())]
        want = [j.observe(i, x) for i, x in enumerate(_latencies())]
        assert got == want and t.flagged == j.flagged
        assert (t.mean, t.var, t.n, t.ewma_quantile()) == (j.mean, j.var, j.n, j.ewma_quantile())
    assert issubclass(tfault.SimulatedFailure, RuntimeError)


@pytest.mark.parametrize("slo_kw", [dict(p99_ms=40.0), dict(p99_ms=25.0, patience=3, alpha=0.3),
                                    dict(p99_ms=60.0, recover_factor=0.9, z_p99=1.0)])
def test_tracker_and_controller_equal_reference(slo_kw):
    tslo, jslo = tserving.SLOConfig(**slo_kw), jserving.SLOConfig(**slo_kw)
    assert tslo.effective_deadline_ms == jslo.effective_deadline_ms
    tt, jt = tserving.LatencyTracker(tslo), jserving.LatencyTracker(jslo)
    tc, jc = tserving.DegradationController(tslo, 5), jserving.DegradationController(jslo, 5)
    got, want = [], []
    for i, x in enumerate(_latencies()):
        tt.observe(x)
        jt.observe(x)
        got.append((tt.p99_ms, tt.n, tc.on_batch(tt.p99_ms, i % 11 != 0)))
        want.append((jt.p99_ms, jt.n, jc.on_batch(jt.p99_ms, i % 11 != 0)))
    assert got == want
    assert (tc.degrades, tc.recoveries) == (jc.degrades, jc.recoveries)
    assert tc.degrades > 0 and tc.recoveries > 0
    for mod in (tserving, jserving):
        with pytest.raises(ValueError, match="at least one ladder rung"):
            mod.DegradationController(tslo, 0)


# --- the ladder and the shard set over a handed-over index ------------------


def test_handed_over_ladder_equals_reference(built):
    jidx, jq, jladder, tidx, tq, tladder = built
    assert len(tladder) == len(jladder) >= 2
    for t, j in zip(tladder, jladder):
        _assert_plan_equal(t, j)
    assert tidx.plan_ladder(tq) is tladder
    _assert_plan_equal(tidx.plans[tq], tladder[0])  # the loaded reference memo


def _assert_shard_answer(t, j):
    assert t.ids.dtype == j.ids.dtype == np.int64 and t.dists.dtype == j.dists.dtype
    np.testing.assert_array_equal(t.ids, j.ids)
    np.testing.assert_allclose(t.dists, j.dists, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.n_candidates, j.n_candidates)
    assert t.coverage == j.coverage


@pytest.fixture(scope="module")
def int8_pair(tmp_path_factory):
    """A reference-built int8 index (tests/test_quant.py's ShardSet case) and
    its plan, handed over with the calibration sample."""
    rng = np.random.default_rng(5)
    data = rng.uniform(0, 1, (N, D)).astype(np.float32)
    space = japi.BoundedSpace(0.0, 1.0, 16.0)
    cfg = japi.IndexConfig(d=D, M=16, K=6, L=12, family="theta", max_candidates=64,
                           space=space, storage="int8")
    jidx = japi.Index.build(jax.random.PRNGKey(3), data, cfg)
    tidx = _handed_over(jidx, tmp_path_factory.mktemp("ref8") / "index")
    jq, tq = (m.QualitySpec(k=K, recall_target=0.8, calibration_queries=16) for m in (japi, tapi))
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # best-effort warnings: test_torch_planner.py's
        Handover(mp)
        jplan = jidx.plan(jq)
        tplan = tidx.plan(tq)
    return jidx, jplan, tidx, tplan


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_shardset_exact_and_planned_equal_reference(storage, built, int8_pair, qw, tmp_path):
    if storage == "f32":
        jidx, _, jladder, tidx, _, tladder = built
        jplan, tplan = jladder[0], tladder[0]
    else:
        jidx, jplan, tidx, tplan = int8_pair
        assert jplan.screen_alpha == tplan.screen_alpha
    _assert_plan_equal(tplan, jplan)
    jss = jserving.ShardSet.build(jidx, 4, str(tmp_path / "ref"))
    tss = tserving.ShardSet.build(tidx, 4, str(tmp_path / "port"))
    assert tss.offsets == jss.offsets and tss.n_rows == jss.n_rows == N
    for shard in tss.shards:
        assert shard.config == tidx.config and shard.device.type == "cpu"
        assert shard.state.data.dtype == tidx.state.data.dtype
        assert np.array_equal(shard.build_key, np.asarray(jidx.build_key))
    for jspec, tspec in ((japi.QuerySpec(k=K, mode="exact"), tapi.QuerySpec(k=K, mode="exact")),
                         (jplan, tplan)):
        _assert_shard_answer(tss.query(*qw, tspec), jss.query(*qw, jspec))
    if storage == "f32":
        # shard-exact + host merge == single-host exact (the merge is exact;
        # an int8 shard refits its own scales, so only f32 rows compare)
        got = tss.query(*qw, tapi.QuerySpec(k=K, mode="exact"))
        ref = tidx.query(*qw, tapi.QuerySpec(k=K, mode="exact"))
        np.testing.assert_array_equal(got.ids, ref.ids.numpy())
        np.testing.assert_allclose(got.dists, ref.dists.numpy(), rtol=1e-6)
    # a killed shard: coverage and the sentinel block, then recovery
    for ss in (tss, jss):
        ss.arm_failure(1)
    _assert_shard_answer(tss.query(*qw, tplan), jss.query(*qw, jplan))
    assert tss.coverage == 0.75 and tss.live == [True, False, True, True]
    tss.recover_now(1)
    jss.recover_now(1)
    _assert_shard_answer(tss.query(*qw, tplan), jss.query(*qw, jplan))


# --- the broker: field by field in virtual time -----------------------------


def _assert_responses_equal(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        assert (t.rid, t.status, t.rung, t.coverage, t.shed_reason) == (
            j.rid, j.status, j.rung, j.coverage, j.shed_reason)
        assert t.latency_ms == j.latency_ms
        assert t.predicted_recall == j.predicted_recall
        np.testing.assert_allclose(t.predicted_success, j.predicted_success, rtol=RTOL)
        if j.spec is None:
            assert t.spec is None and t.ids is None and t.dists is None
            continue
        _assert_plan_equal(t.spec, j.spec)
        ji, jd = np.asarray(j.ids), np.asarray(j.dists)
        assert t.ids.dtype == ji.dtype and t.dists.dtype == jd.dtype
        np.testing.assert_array_equal(t.ids, ji)
        np.testing.assert_allclose(t.dists, jd, rtol=1e-5, atol=1e-5)


def _assert_stats_equal(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _run_both(built, qw, arrivals, slo_kw, cfg_kw, svc, shardsets=(None, None)):
    jidx, jq, _, tidx, tq, _ = built
    jb = jserving.Broker(jidx, jq, jserving.SLOConfig(**slo_kw),
                         jserving.BrokerConfig(**cfg_kw), shardset=shardsets[1],
                         service_time_fn=svc)
    tb = tserving.Broker(tidx, tq, tserving.SLOConfig(**slo_kw),
                         tserving.BrokerConfig(**cfg_kw), shardset=shardsets[0],
                         service_time_fn=svc)
    jr, js = jb.run(jserving.requests_from_trace(arrivals, *qw))
    tr, ts = tb.run(tserving.requests_from_trace(arrivals, *qw))
    tb.assert_no_retrace()
    assert tb.buckets == jb.buckets
    _assert_responses_equal(tr, jr)
    _assert_stats_equal(ts, js)
    return tb, tr, ts


def test_broker_overload_equal_reference(built, qw):
    """tests/test_serving.py's overload case: rung 0 cannot sustain the
    load, the controller degrades, every degraded answer is labeled."""
    tladder = built[5]
    tb, tr, ts = _run_both(built, qw, np.arange(300) * (1 / 400.0),
                           dict(p99_ms=30.0, patience=10_000),
                           dict(max_batch=4, max_queue=512),
                           lambda bucket, rung, spec: 0.02 if rung == 0 else 0.002)
    assert ts.shed == 0 and ts.degrades >= 1 and max(ts.rung_counts) > 0
    assert tb.tracker.p99_ms <= 30.0
    for r in tr:
        if r.rung > 0:
            assert r.status == "degraded"
            assert r.predicted_recall == float(tladder[r.rung].predicted_recall)
            assert r.predicted_success == float(tladder[r.rung].predicted_success)


def test_broker_shed_equal_reference(built, qw):
    """tests/test_serving.py's admission case: queue overflow and deadline
    expiry both shed, with their reasons."""
    _, tr, ts = _run_both(built, qw, np.arange(40) * 1e-3,
                          dict(p99_ms=10.0, deadline_ms=25.0, patience=10_000),
                          dict(max_batch=2, max_queue=4), lambda bucket, rung, spec: 0.02)
    assert {r.shed_reason for r in tr if r.status == "shed"} == {"queue_full", "deadline"}
    assert ts.served + ts.shed == 40 and ts.shed_rate > 0.0


def test_broker_chaos_kill_and_recovery_equal_reference(built, qw, tmp_path):
    """tests/test_serving.py's chaos case: shard 2 dies mid-stream, two
    injected recovery failures with capped backoff, then a bit-identical
    recovery — the log, the backoffs and every response as the reference."""
    jidx, jq, jladder, tidx, tq, tladder = built
    jss = jserving.ShardSet.build(jidx, 4, str(tmp_path / "ref"))
    tss = tserving.ShardSet.build(tidx, 4, str(tmp_path / "port"))
    pre = tss.query(*qw, tladder[0])
    base, cap = 0.01, 0.015
    for ss, mod in ((jss, jserving), (tss, tserving)):
        ss.chaos = mod.ChaosPlan(kill_shard=2, kill_at_s=0.05, recovery_failures=2,
                                 backoff_base_s=base, backoff_cap_s=cap)
    _, tr, ts = _run_both(built, qw, np.arange(200) * (1 / 500.0), dict(p99_ms=1e6),
                          dict(max_batch=4, max_queue=256), lambda b, r, s: 0.004,
                          shardsets=(tss, jss))
    assert tss.recovery_log == jss.recovery_log
    assert [e["event"] for e in tss.recovery_log] == [
        "killed", "recover_failed", "recover_failed", "recovered"]
    assert [e["next_backoff_s"] for e in tss.recovery_log
            if e["event"] == "recover_failed"] == [base, cap]
    served = [r for r in tr if r.status != "shed"]
    assert {round(r.coverage, 6) for r in served} == {0.75, 1.0}
    lo, hi = 2 * (N // 4), 3 * (N // 4)
    for r in served:
        if r.coverage < 1.0:
            assert r.status == "degraded" and not ((r.ids >= lo) & (r.ids < hi)).any()
    assert tss.coverage == 1.0 and ts.mean_coverage < 1.0
    post = tss.query(*qw, tladder[0])
    np.testing.assert_array_equal(pre.ids, post.ids)
    np.testing.assert_array_equal(pre.dists, post.dists)


def test_bucket_ladder_and_ragged_arrivals(built, qw):
    """Measured (wall-clock) service: every bucket size runs, nothing is
    built after warmup, every request is answered once."""
    _, _, _, tidx, tq, _ = built
    broker = tserving.Broker(tidx, tq, tserving.SLOConfig(p99_ms=50.0),
                             tserving.BrokerConfig(max_batch=8, warmup=False))
    assert broker.buckets == [1, 2, 4, 8]
    assert [broker.bucket_for(m) for m in (1, 3, 8, 99)] == [1, 4, 8, 8]
    with pytest.raises(RuntimeError, match="warmup"):
        broker.assert_no_retrace()
    broker = tserving.Broker(tidx, tq, tserving.SLOConfig(p99_ms=1e6),
                             tserving.BrokerConfig(max_batch=8, max_queue=64))
    arrivals = np.cumsum(np.resize([1e-4, 1e-4, 1e-4, 0.05, 1e-4, 0.05], 60))
    responses, stats = broker.run(tserving.requests_from_trace(arrivals, *qw))
    broker.assert_no_retrace()
    assert stats.served == 60 and stats.shed == 0
    assert sorted(r.rid for r in responses) == list(range(60))
    assert all(r.status == "ok" and r.ids.dtype == np.int32 and r.dists.dtype == np.float32
               for r in responses)


# --- the rebuild guard ------------------------------------------------------


def test_guard_raises_when_a_library_loads_after_warmup(built, monkeypatch):
    _, _, _, tidx, tq, _ = built
    broker = tserving.Broker(tidx, tq, tserving.SLOConfig(p99_ms=50.0),
                             tserving.BrokerConfig(max_batch=2))
    broker.assert_no_retrace()
    monkeypatch.setattr(_build, "_LIBRARY_LOADS", _build.library_loads() + 1)
    with pytest.raises(RetraceError, match="during serving") as e:
        broker.assert_no_retrace()
    assert isinstance(e.value, AssertionError)
    guard = RetraceGuard()
    with pytest.raises(RuntimeError, match="snapshot"):
        guard.assert_no_retrace()
    count = [0]
    with pytest.raises(RetraceError):
        with RetraceGuard(fn=lambda: count[0]) as g:
            assert g.snapshotted and g.baseline == 0
            count[0] += 1


def test_kernel_lib_counts_each_load_once(monkeypatch):
    """``Kernel.lib`` counts a build-or-load once per kernel; later calls
    reuse the loaded library and count nothing."""

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    k = _build.Kernel("fake", "alsh_project.cu", {"fake_launch": [_build._I]})
    monkeypatch.setattr(_build.Kernel, "start_build", lambda self: None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    before = _build.library_loads()
    k.lib()
    k.lib()
    assert _build.library_loads() == before + 1


# --- serve --mode broker on the CPU -----------------------------------------


@pytest.mark.parametrize("chaos", [False, True], ids=["single", "shards_kill"])
def test_serve_broker_runs_on_cpu(chaos, capsys):
    from repro_torch.launch import serve

    argv = ["--mode", "broker", "--device", "cpu", "--n", "256", "--d", "8", "--requests",
            "400", "--slo-p99-ms", "1e6", "--max-queue", "4096"]
    if chaos:
        argv += ["--shards", "4", "--kill-shard", "1", "--kill-at", "0.1"]
    responses, stats = serve.main(argv)
    out = capsys.readouterr().out
    assert "[broker] built+planned n=256 d=8" in out and "[broker] p50=" in out
    assert len(responses) == 400 and stats.served + stats.shed == 400
    assert ("chaos assertions passed" in out) == chaos
