"""A whole run of the harness at a tiny size on the CPU: the program's
plain path against the reference, the result line, the control and the
faults the comparison has to catch."""

import json

import pytest
import torch

from portbench import harness
from portbench.tests.tiny import TRAFFICS, tiny_cell

SEED = 2**33 + 5  # beyond 32 signed bits, as a run's seed may be
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(traffic, tracing=False, seconds=0.3):
    return harness.run(tiny_cell(traffic), SEED, seconds, tracing, device="cpu")


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_sound_run_is_correct_and_keeps_to_the_schema(traffic):
    r = _run(traffic)
    assert r["correct"], r["checks"]
    keys = list(r)
    assert keys[: len(RESULT_KEYS)] == RESULT_KEYS and keys[-1] == "checks"
    assert r["attempted"] > 0 and r["failed"] == 0
    # no card: no peak; a percentile needs two batches, which a loaded CPU may not finish
    timed = {"batch_p95_ms"} if r["attempted"] >= 2 * tiny_cell(traffic).traffic["batch"] else set()
    assert set(r["metrics"]) == {"qps", "setup_s"} | timed
    for m in r["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(r["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(r, allow_nan=False))


def test_traced_run_reads_no_device_metric_without_a_card():
    r = _run("probe-b1k", tracing=True)
    assert r["correct"]
    assert set(r["metrics"]) == {"build_ms"}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_control_is_not_correct(traffic):
    out = harness.control(tiny_cell(traffic), SEED, device="cpu")
    assert not out["correct"], out["checks"]


def _alter_answer(monkeypatch, traffic):
    """One answer altered where it is produced: query 0's nearest row
    replaced by the next row, its distance kept."""
    from repro_torch.kernels import ops

    name = "wl1_scan_topk" if traffic == "exact-b1k" else "gather_rerank_topk"
    real = getattr(ops, name)

    def altered(*args, **kwargs):
        dists, ids = real(*args, **kwargs)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % 4096
        return dists, ids

    monkeypatch.setattr(ops, name, altered)


def _half_batch(monkeypatch, traffic):
    """Half of the batch left out: the first half answered, its answers
    repeated for the rest."""
    from repro_torch import engine

    real = engine.query

    def half(state, delta, tomb, queries, weights, *args, **kwargs):
        h = queries.shape[0] // 2
        res = real(state, delta, tomb, queries[:h], weights[:h], *args, **kwargs)
        return res._replace(**{f: torch.cat([getattr(res, f)] * 2)
                               for f in ("dists", "ids", "n_candidates")})

    monkeypatch.setattr(engine, "query", half)


def _flip_key_bit(monkeypatch, traffic):
    """A query hash key gone wrong: bit 0 of every probe key of table 0
    flipped."""
    from repro_torch.engine import pipeline

    real = pipeline.probe_keys

    def flipped(*args, **kwargs):
        keys = real(*args, **kwargs).clone()
        keys[:, 0] ^= 1
        return keys

    monkeypatch.setattr(pipeline, "probe_keys", flipped)


def _shift_window(monkeypatch, traffic):
    """A window probe gone wrong: every window starts one row late."""
    from repro_torch.core import index
    from repro_torch.engine import sources

    def shifted(sorted_keys, perm, keys_lb, C):
        start = index._searchsorted(sorted_keys, keys_lb, right=False) + 1
        end = index._searchsorted(sorted_keys, keys_lb, right=True)
        pos = (start[:, :, None] + torch.arange(C)).clamp(max=perm.shape[1] - 1)
        L, m = keys_lb.shape
        ids = torch.gather(perm, 1, pos.reshape(L, m * C)).reshape(L, m, C)
        return torch.where(pos < end[:, :, None], ids, torch.full_like(ids, perm.shape[1]))

    monkeypatch.setattr(sources, "_probe_one_table", shifted)


FAULTS = {"answer": _alter_answer, "half_batch": _half_batch, "key": _flip_key_bit,
          "window": _shift_window}
HASHED = [t for t in TRAFFICS if t != "exact-b1k"]  # the exact scan hashes nothing
CASES = [(t, f) for t in TRAFFICS for f in FAULTS if t in HASHED or f in ("answer", "half_batch")]


@pytest.mark.parametrize("traffic,fault", CASES, ids=[f"{t}-{f}" for t, f in CASES])
def test_faults_are_not_correct(monkeypatch, fault, traffic):
    FAULTS[fault](monkeypatch, traffic)
    r = _run(traffic)
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_tiny_cell_on_the_card(cuda_card):
    r = harness.run(tiny_cell("probe-b1k"), SEED, 0.5, True, device="cuda")
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["busy_s"] > 0
    assert "roofline.gather_rerank_topk" in r["metrics"]


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
