"""Port parity of the offline autotuner (CPU): ``repro_torch.tuner`` and
``Planner(table=...)``.

* The scan space: axis helpers, validation messages, the enumeration, and
  ``trial_id``/``space_id`` equal to the reference's, byte for byte.
* Pareto: ``dominates``/``pareto_front`` on the reference tests' edge
  cases; ``build_table`` from equal records writes equal bytes in both
  packages, and each package reads the other's table.
* The trial store: torn trailing line, interior corruption, an alien space,
  a resume that ends bit-identical to one full scan, stores read across
  packages, and a 2-worker spawn pool equal to the inline scan.
* ``run_trial`` with the reference's data, width sample and tables handed
  over records the reference's deterministic fields (W within rtol 1e-6).
* The prior path: in bucket (confirmed, ``provenance="prior"``, equal to the
  reference's prior plan on the same index and sample), out of bucket (the
  table-less plan, bit for bit), a table written by the other package, and
  the tuning stamp through save/load.

The 6-trial space at n=400 is the reference tests'. Trials run on the CPU
(``device="cpu"``); ``shards > 1`` trials are recorded as skipped, as the
reference records them, when the host has too few devices, and run on a
``ShardedIndex`` when it has enough.
"""

import dataclasses
import json
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.tuner as jtuner
import repro_torch.api as tapi
import repro_torch.tuner as ttuner
from repro.api import planner as jplanner
from repro.core.transforms import BoundedSpace as JSpace
from repro.tuner import pareto as jpareto
from repro.tuner import space as jspace
from repro_torch.api import planner as tplanner
from repro_torch.core.transforms import BoundedSpace as TSpace
from repro_torch.tuner import pareto as tpareto
from repro_torch.tuner import scan as tscan

AXES = dict(families=("theta", "l2"), K=(3, 4), L=(8,), W=("auto",), n_probes=(1, 2),
            window=(64,), k=3, queries=8)
SPACE = ttuner.ScanSpace(profiles=(ttuner.DataProfile(n=400, d=6),), **AXES)
JSPACE = jtuner.ScanSpace(profiles=(jtuner.DataProfile(n=400, d=6),), **AXES)
QUALITY = dict(k=3, recall_target=0.6, calibration_queries=8)


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


def _rec(trial_id, recall, cost, mem=100, **kw):
    return {"trial_id": trial_id, "status": "ok", "recall": recall, "cost": cost,
            "mem_bytes": mem, **kw}


def _leaves(jindex):
    s = jindex.state
    return {
        "folded": np.asarray(s.tables.folded), "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers), "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm), "data": np.asarray(s.data), "levels": np.asarray(s.levels),
        "scales": None if s.scales is None else np.asarray(s.scales),
    }


@pytest.fixture(scope="module")
def scanned(tmp_path_factory):
    """One full inline scan of SPACE on the CPU and its table."""
    store = tmp_path_factory.mktemp("tuner") / "trials.jsonl"
    records = ttuner.run_scan(SPACE, store, device="cpu")
    return store, records, ttuner.build_table(records, SPACE)


# ---------------------------------------------------------------------------
# the scan space
# ---------------------------------------------------------------------------


def test_axis_helpers_match_reference():
    for args in ((3, 1, 3, 2), (), ("auto", 2.0, "auto")):
        assert ttuner.grid(*args) == jtuner.grid(*args)
    for args in ((4, 64, 3), (8, 8, 1), (1, 1000, 7), (3, 5, 9)):
        assert ttuner.log_range(*args) == jtuner.log_range(*args)
    for values, num, seed in ((range(100), 5, 3), (range(100), 5, 4), ((1, 2), 9, 0),
                              (range(7), 7, 1), ((8, 12, 16, 24), 2, 11)):
        assert ttuner.seeded_choice(values, num, seed) == jtuner.seeded_choice(values, num, seed)
    with pytest.raises(ValueError) as got:
        ttuner.log_range(0, 8, 2)
    with pytest.raises(ValueError) as want:
        jtuner.log_range(0, 8, 2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("make", [
    lambda t: t.DataProfile(n=10, d=2, source="mystery"),
    lambda t: t.DataProfile(n=10, d=2, skew=0.0),
    lambda t: t.DataProfile(n=0, d=2),
    lambda t: t.ScanSpace(profiles=()),
    lambda t: t.ScanSpace(profiles=(t.DataProfile(n=10, d=2),), families=("nope",)),
])
def test_validation_messages_match_reference(make):
    with pytest.raises(ValueError) as got:
        make(ttuner)
    with pytest.raises(ValueError) as want:
        make(jtuner)
    assert str(got.value) == str(want.value)


SPACE_VARIANTS = {
    "base": {},
    "theta-W": dict(families=("theta",), W=(2.0, 8.0)),
    "l2": dict(families=("l2",), W=("auto", 3.5)),
    "caps": dict(families=("theta",), K=(3, 40), window=(2, 64)),
    "early-exit": dict(early_exit=(False, True), exit_group=(2, 4), L=(4, 8), n_probes=(1, 4)),
    "profiles": dict(profiles=(("clustered", 400, 6, 1.5), ("sampled", 64, 6, 1.0),
                               ("uniform", 2, 6, 1.0))),
    "shards": dict(shards=2, base_seed=7, queries=16, M=16),
}


def _spaces(variant):
    over = dict(SPACE_VARIANTS[variant])
    pairs = []
    for pkg, base in ((ttuner, SPACE), (jtuner, JSPACE)):
        kw = dict(over)
        if "profiles" in kw:
            kw["profiles"] = tuple(pkg.DataProfile(n=n, d=d, skew=s, source=src)
                                   for src, n, d, s in kw["profiles"])
        pairs.append(dataclasses.replace(base, **kw) if kw else base)
    return pairs


@pytest.mark.parametrize("variant", list(SPACE_VARIANTS))
def test_enumeration_and_ids_match_reference(variant):
    got, want = _spaces(variant)
    assert got.space_id == want.space_id
    assert got.to_dict() == want.to_dict()
    gt, wt = got.trials(), want.trials()
    assert [t.trial_id for t in gt] == [t.trial_id for t in wt]
    assert [t.to_dict() for t in gt] == [t.to_dict() for t in wt]
    assert [t.seed for t in gt] == [t.seed for t in wt]
    assert ttuner.ScanSpace.from_dict(want.to_dict()).space_id == want.space_id
    for t in gt:
        assert ttuner.TrialSpec.from_dict(t.to_dict()) == t


def test_enumeration_rules():
    s = dataclasses.replace(SPACE, families=("theta",), W=(2.0, 8.0))
    assert len(s.trials()) == 4 and all(t.W == 4.0 for t in s.trials())
    s = dataclasses.replace(SPACE, families=("l2",))
    assert len(s.trials()) == 2 and all(t.n_probes == 1 for t in s.trials())
    t = SPACE.trials()[0]
    assert dataclasses.replace(t, L=t.L + 1).trial_id != t.trial_id


# ---------------------------------------------------------------------------
# pareto and the table
# ---------------------------------------------------------------------------

FRONT_CASES = {
    "single": [_rec("x", recall=0.5, cost=99)],
    "empty": [],
    "duplicates": [_rec("bbbb", recall=0.9, cost=10), _rec("aaaa", recall=0.9, cost=10)],
    "duplicates-reversed": [_rec("aaaa", recall=0.9, cost=10), _rec("bbbb", recall=0.9, cost=10)],
    "partial-ties": [_rec("a", recall=0.9, cost=10, mem=100), _rec("b", recall=0.9, cost=20, mem=50),
                     _rec("c", recall=0.8, cost=25, mem=60),
                     _rec("d", recall=1.0, cost=0, mem=0, status="skipped")],
    "dominated": [_rec("a", recall=0.9, cost=10), _rec("b", recall=0.8, cost=20),
                  _rec("t", recall=0.9, cost=10)],
}


@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_pareto_front_matches_reference(case):
    recs = FRONT_CASES[case]
    assert ttuner.pareto_front(recs) == jtuner.pareto_front(recs)
    for a in recs:
        for b in recs:
            assert tpareto.dominates(a, b) == jpareto.dominates(a, b)


def test_table_bytes_equal_and_read_across_packages(scanned, tmp_path):
    _, records, table = scanned
    want = jtuner.build_table(records, JSPACE)
    assert table.to_dict() == want.to_dict()
    table.save(tmp_path / "port.json")
    want.save(tmp_path / "ref.json")
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert jtuner.TuningTable.load(tmp_path / "port.json").to_dict() == table.to_dict()
    loaded = ttuner.TuningTable.load(tmp_path / "ref.json")
    assert loaded.to_dict() == table.to_dict()
    assert loaded.provenance() == want.provenance() and loaded.provenance()["space_id"] == (
        SPACE.space_id)
    for fam, n, d, skew in (("theta", 400, 6, 1.0), ("theta", 700, 6, 1.0), ("theta", 4000, 6, 1.0),
                            ("theta", 400, 7, 1.0), ("theta", 400, 6, 2.0), (None, 400, 6, 1.0)):
        assert loaded.nearest_bucket(fam, n, d, skew) == want.nearest_bucket(fam, n, d, skew)
    bucket = loaded.nearest_bucket("theta", 400, 6)
    for target in (0.0, 0.5, 0.9, 2.0):
        assert ttuner.TuningTable.best_entry(bucket, target) == (
            jtuner.TuningTable.best_entry(bucket, target))
    doc = loaded.to_dict()
    for edit in ({"version": 99}, {"format": "something.else"}):
        (tmp_path / "bad.json").write_text(json.dumps(doc | edit))
        with pytest.raises(ValueError) as got:
            ttuner.TuningTable.load(tmp_path / "bad.json")
        with pytest.raises(ValueError) as ref:
            jtuner.TuningTable.load(tmp_path / "bad.json")
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the trial store and the scan
# ---------------------------------------------------------------------------


def test_store_tolerates_torn_trailing_line(tmp_path, scanned):
    _, records, _ = scanned
    store = ttuner.TrialStore(tmp_path / "torn.jsonl")
    store.write_header(SPACE)
    store.append(records[0])
    with open(store.path, "a") as f:
        f.write('{"trial_id": "abc", "trunc')
    assert set(store.load(SPACE)) == {records[0]["trial_id"]}
    assert set(jtuner.TrialStore(store.path).load(JSPACE)) == {records[0]["trial_id"]}


def test_store_refuses_interior_corruption_and_alien_space(tmp_path, scanned):
    _, records, _ = scanned
    store = ttuner.TrialStore(tmp_path / "corrupt.jsonl")
    store.write_header(SPACE)
    with open(store.path, "a") as f:
        f.write("not json\n")
    store.append(records[0])
    with pytest.raises(ValueError, match="corrupt"):
        store.load(SPACE)
    other = ttuner.TrialStore(tmp_path / "alien.jsonl")
    other.write_header(dataclasses.replace(SPACE, base_seed=9))
    with pytest.raises(ValueError, match="fresh store"):
        other.load(SPACE)
    bad = ttuner.TrialStore(tmp_path / "alien_ids.jsonl")
    bad.write_header(SPACE)
    bad.append({"trial_id": "f" * 16, "status": "ok"})
    with pytest.raises(ValueError, match="not in this scan space"):
        ttuner.run_scan(SPACE, bad.path, device="cpu")


def test_resume_completes_grid_bit_identically(tmp_path, scanned):
    _, records_full, reference = scanned
    store = tmp_path / "partial.jsonl"
    first = ttuner.run_scan(SPACE, store, max_trials=2, device="cpu")
    assert len(first) == 2 and not ttuner.scan_is_complete(SPACE, store)
    assert not jtuner.scan_is_complete(JSPACE, store)  # the reference reads the port's store
    with open(store, "a") as f:
        f.write('{"torn')
    records = ttuner.run_scan(SPACE, store, device="cpu")
    assert ttuner.scan_is_complete(SPACE, store) and jtuner.scan_is_complete(JSPACE, store)
    want_ids = [t.trial_id for t in SPACE.trials()]
    assert [r["trial_id"] for r in records] == want_ids
    with open(store) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    assert sorted(json.loads(ln)["trial_id"] for ln in lines[1:]) == sorted(want_ids)
    table = ttuner.build_table(records, SPACE)
    assert json.dumps(table.to_dict(), sort_keys=True) == json.dumps(reference.to_dict(),
                                                                     sort_keys=True)


def test_rerun_trial_is_deterministic(scanned):
    _, records, _ = scanned
    for rec in (records[0], records[-1]):  # theta, and l2 with W="auto"
        again = ttuner.run_trial(rec["trial"], device="cpu")
        for key in ("recall", "cand_frac", "cost", "mem_bytes", "W", "tables_probed"):
            assert again[key] == rec[key], key


def test_sharded_trials_are_skipped_with_a_reason(monkeypatch):
    """On a host with fewer devices than a trial's shards (here: the CPU, one
    device; the reference is shown one JAX device, whatever XLA_FLAGS an
    earlier test of the process set) both packages record the same skipped
    trial, with the reference's reason."""
    t = dataclasses.replace(SPACE, shards=2).trials()[0]
    jt = dataclasses.replace(JSPACE, shards=2).trials()[0]
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    rec = ttuner.run_trial(t.to_dict(), device="cpu")
    assert rec["status"] == "skipped" and rec["reason"] == "needs 2 devices, host has 1"
    assert rec == jtuner.run_trial(jt.to_dict())
    assert ttuner.pareto_front([rec]) == []


def test_sharded_trial_runs_when_the_host_has_the_devices(monkeypatch):
    """With two devices of its kind (here the CPU, counted twice) a
    ``shards=2`` trial runs on a ShardedIndex over both: its record is
    complete, and carries no ``tables_probed`` (a sharded answer has none)."""
    t = dataclasses.replace(SPACE, shards=2).trials()[0]
    monkeypatch.setattr(tscan, "_host_devices", lambda dev: [dev, dev])
    rec = ttuner.run_trial(t.to_dict(), device="cpu")
    assert rec["status"] == "ok" and rec["shards"] == 2 and 0.0 <= rec["recall"] <= 1.0
    assert rec["cand_frac"] > 0 and rec["mem_bytes"] > 0 and rec["tables_probed"] is None


def test_worker_pool_matches_inline(tmp_path):
    """Spawned workers reproduce the inline records' deterministic fields."""
    tiny = ttuner.ScanSpace(profiles=(ttuner.DataProfile(n=64, d=4),), families=("theta",),
                            K=(3, 4), L=(4,), n_probes=(1,), window=(16,), k=2, queries=4)
    inline = ttuner.run_scan(tiny, tmp_path / "inline.jsonl", device="cpu")
    pooled = ttuner.run_scan(tiny, tmp_path / "pooled.jsonl", workers=2, device="cpu")
    assert len(inline) == len(pooled) == 2
    for a, b in zip(inline, pooled):
        for key in ("trial_id", "recall", "cand_frac", "cost", "mem_bytes", "W"):
            assert a[key] == b[key], key


def test_worker_launches_reach_the_parent(monkeypatch):
    """A pooled trial returns the launches its worker counted, and the
    parent adds them to its own counts (here a stand-in trial: plain
    versions on the CPU launch nothing)."""
    from repro_torch.kernels import _build
    from repro_torch.tuner import scan as tscan

    def fake_trial(trial_dict, real_data=None, device=None):
        _build.KERNELS["wl1_scan_topk"].launches += 2
        _build.KERNELS["gather_rerank_topk"].launches += 1
        return {"trial_id": trial_dict["id"]}

    monkeypatch.setattr(tscan, "run_trial", fake_trial)
    _build.KERNELS["wl1_scan_topk"].launches = 5  # a worker starts from zero
    rec, launches = tscan._pool_trial(({"id": "t"}, None, "cpu"))
    assert rec == {"trial_id": "t"}
    assert launches == {**{n: 0 for n in _build.KERNELS}, "wl1_scan_topk": 2,
                        "gather_rerank_topk": 1}
    _build.reset_launch_counts()
    _build.add_launch_counts(launches)
    _build.add_launch_counts(launches)
    assert _build.launch_counts()["wl1_scan_topk"] == 4
    assert _build.launch_counts()["gather_rerank_topk"] == 2
    _build.reset_launch_counts()


def _reference_trial_inputs(trial):
    """What the reference's ``run_trial`` draws for ``trial``: its data,
    its width sample, its index leaves, its queries and weights."""
    key = jax.random.PRNGKey(trial.seed)
    data = jspace.profile_data(trial.profile, jax.random.fold_in(key, 0))
    k_rows, k_j, k_w = jax.random.split(jax.random.fold_in(key, 1), 3)
    m = min(trial.queries, trial.profile.n)
    rows = jax.random.choice(k_rows, data.shape[0], (m,), replace=False)
    t = float(trial.M)
    width_qs = data[rows] + jax.random.uniform(k_j, (m, trial.profile.d), minval=-1 / t,
                                               maxval=1 / t)
    width_ws = jspace.profile_weights(k_w, (m, trial.profile.d), trial.profile.skew)
    qs = jspace.profile_queries(trial.profile, jax.random.fold_in(key, 3), trial.queries)
    ws = jspace.profile_weights(jax.random.fold_in(key, 4), (trial.queries, trial.profile.d),
                                trial.profile.skew)
    return {k: np.asarray(v) for k, v in dict(data=data, width_qs=width_qs, width_ws=width_ws,
                                              qs=qs, ws=ws).items()}, key


@pytest.mark.parametrize("i", [0, 1, 4])
def test_run_trial_matches_reference_with_data_handed_over(i):
    """Trials 0, 1 (theta, probe and multiprobe) and 4 (l2, W="auto")."""
    trial = SPACE.trials()[i]
    want = jtuner.run_trial(trial.to_dict())
    arrays, key = _reference_trial_inputs(jtuner.TrialSpec.from_dict(trial.to_dict()))

    def tables(generator, data, cfg, device):
        jcfg = japi.IndexConfig(d=cfg.d, M=cfg.M, K=cfg.K, L=cfg.L, family=cfg.family, W=cfg.W,
                                max_candidates=cfg.max_candidates, space=JSpace(*cfg.space))
        jidx = japi.Index.build(jax.random.fold_in(key, 2), arrays["data"], jcfg)
        return tapi.Index.from_numpy(_leaves(jidx), cfg, device=device)

    t = torch.from_numpy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscan, "profile_data", lambda *a, device=None, **k: t(arrays["data"]))
        mp.setattr(tscan, "profile_queries", lambda *a, device=None, **k: t(arrays["qs"]))
        mp.setattr(tscan, "profile_weights", lambda *a, device=None, **k: t(arrays["ws"]))
        mp.setattr(tscan, "_width_sample",
                   lambda *a, **k: (t(arrays["width_qs"]), t(arrays["width_ws"])))
        mp.setattr(tscan, "_trial_index", tables)
        got = ttuner.run_trial(trial.to_dict(), device="cpu")
    assert got["trial_id"] == want["trial_id"] and got["trial"] == want["trial"]
    for k in ("status", "family", "K", "L", "n_probes", "max_flips", "window", "k", "shards",
              "early_exit", "exit_group", "exit_slack", "tables_probed", "recall", "mem_bytes"):
        assert got[k] == want[k], k
    for k in ("W", "cand_frac", "cost"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert set(got) == set(want)


# ---------------------------------------------------------------------------
# the prior path
# ---------------------------------------------------------------------------


def _workload(n=400, d=6, salt=200):
    rng = jax.random.PRNGKey(salt)
    data = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 0), (n, d)))
    q = np.asarray(jax.random.uniform(jax.random.fold_in(rng, 1), (4, d)))
    w = np.asarray(jnp.abs(jax.random.normal(jax.random.fold_in(rng, 2), (4, d))) + 0.2)
    return data, q, w


def _prior_pair(table_entry, d=6, salt=210):
    """The same index in both packages, built with the geometry of a
    frontier entry (so the prior applies)."""
    data, q, w = _workload(d=d, salt=salt)
    kw = dict(d=d, M=32, K=table_entry["K"], L=table_entry["L"], family=table_entry["family"],
              W=float(table_entry["W"]), max_candidates=table_entry["window"])
    jidx = japi.Index.build(jax.random.PRNGKey(salt), data,
                            japi.IndexConfig(space=JSpace(0.0, 1.0, 32.0), **kw))
    tidx = tapi.Index.from_numpy(_leaves(jidx), tapi.IndexConfig(space=TSpace(0.0, 1.0, 32.0),
                                                                 **kw), device="cpu")
    return jidx, tidx, q, w


class _Handover:
    """The reference planner's samples, handed to the port's in call order."""

    def __init__(self, mp):
        self.samples = []
        orig = jplanner.Planner._sample

        def record(planner, key, data, m, jitter):
            qs, ws = orig(planner, key, data, m, jitter)
            self.samples.append((np.asarray(qs), np.asarray(ws)))
            return qs, ws

        def hand(planner, generator, data, m, jitter):
            qs, ws = self.samples.pop(0)
            return torch.from_numpy(qs), torch.from_numpy(ws)

        mp.setattr(jplanner.Planner, "_sample", record)
        mp.setattr(tplanner.Planner, "_sample", hand)


def _nan_free(plan):
    return {k: v for k, v in dataclasses.asdict(plan).items()
            if not (isinstance(v, float) and math.isnan(v)) and k != "predicted_success"}


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_prior_plan_matches_reference_in_bucket(scanned, tmp_path, writer):
    """A table from either package drives both planners' prior path, on the
    same index and sample, to the same confirmed plan."""
    _, records, table = scanned
    path = tmp_path / "table.json"
    (table if writer == "port" else jtuner.build_table(records, JSPACE)).save(path)
    ttable, jtable = ttuner.TuningTable.load(path), jtuner.TuningTable.load(path)
    jq, tq = _qualities()
    entry = ttable.best_entry(ttable.nearest_bucket("theta", 400, 6), tq.recall_target)
    jidx, tidx, q, w = _prior_pair(entry)
    with pytest.MonkeyPatch.context() as mp:
        _Handover(mp)
        want = japi.Planner(table=jtable).plan_query(jidx, jq)
        got = tapi.Planner(table=ttable).plan_query(tidx, tq)
    assert want.provenance == got.provenance == "prior"
    assert _nan_free(got) == _nan_free(want)
    np.testing.assert_allclose(got.predicted_success, want.predicted_success, rtol=1e-6)
    assert got.predicted_recall >= tq.recall_target - tapi.Planner().confirm_slack
    tidx._record_plan(tq, got, tapi.Planner(table=ttable), 0.1)
    assert tidx.tuning == ttable.provenance() == jtable.provenance()
    a = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tq)
    b = tidx.query(torch.from_numpy(q), torch.from_numpy(w), got)
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
    np.testing.assert_array_equal(b.ids.numpy(), np.asarray(jidx.query(q, w, want).ids))


def test_prior_build_stamps_provenance_and_plan_time(scanned):
    _, _, table = scanned
    data, q, w = _workload(salt=230)
    _, tq = _qualities()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tidx = tapi.Index.build(3, data, tq, planner=tapi.Planner(table=table), device="cpu")
    plan = tidx.plans[tq]
    assert plan.provenance == "prior" and tidx.tuning == table.provenance()
    rep = tidx.explain(torch.from_numpy(q), torch.from_numpy(w), tq)
    assert rep.provenance == "prior" and rep.plan_build_s > 0.0
    raw = tidx.explain(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(k=3))
    assert raw.provenance is None and raw.plan_build_s is None


def test_out_of_bucket_falls_back_bit_identically(scanned):
    """d=5 lies in no bucket: the table-backed planner resolves exactly what
    a table-less one does, at build and at query time."""
    _, _, table = scanned
    data, _, _ = _workload(d=5, salt=240)
    _, tq = _qualities()
    cfg = tapi.IndexConfig(d=5, M=8, K=4, L=8, family="theta", max_candidates=64,
                           space=TSpace(0.0, 1.0, 8.0))
    tidx = tapi.Index.build(4, data, cfg, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with_table = tapi.Planner(table=table).plan_query(tidx, tq)
        bare = tapi.Planner().plan_query(tidx, tq)
    assert with_table == bare and with_table.provenance == "calibrated"
    data_t = torch.from_numpy(data)
    assert tapi.Planner(table=table).plan_config(data_t, tq) == tapi.Planner().plan_config(
        data_t, tq)


def test_tuning_stamp_survives_save_load_in_both_packages(scanned, tmp_path):
    _, _, table = scanned
    data, q, w = _workload(salt=260)
    _, tq = _qualities()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tidx = tapi.Index.build(5, data, tq, planner=tapi.Planner(table=table), device="cpu")
    assert tidx.plans[tq].provenance == "prior"
    tidx.save(tmp_path / "idx")
    meta = json.loads((tmp_path / "idx" / "index.json").read_text())
    assert meta["version"] == 5 and meta["tuning"] == table.provenance()
    back = tapi.Index.load(tmp_path / "idx", device="cpu")
    assert back.tuning == table.provenance() and back.plans == tidx.plans
    assert back.plan_times == {}  # wall seconds stay in the process that planned
    jback = japi.Index.load(str(tmp_path / "idx"))
    assert jback.tuning == table.provenance()
    (jq, jplan), = jback.plans.items()
    assert dataclasses.asdict(jq) == dataclasses.asdict(tq)
    assert dataclasses.asdict(jplan) == dataclasses.asdict(tidx.plans[tq])
    got = back.query(torch.from_numpy(q), torch.from_numpy(w), tq)
    want = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tq)
    assert torch.equal(got.ids, want.ids)
    meta["version"] = 3
    del meta["tuning"]
    (tmp_path / "idx" / "index.json").write_text(json.dumps(meta))
    v3 = tapi.Index.load(tmp_path / "idx", device="cpu")
    assert v3.tuning is None and v3.plans == tidx.plans
