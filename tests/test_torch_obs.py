"""The query path's stage spans (``repro_torch.obs``): nothing recorded and
no CUDA event made without a profiler; under one, ``Index.query`` records
its spans nested in ``repro_torch.query``, on the clock of the caller's own
profiler spans; the timed stages belong to the latest session."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import repro_torch.api as tapi
from repro_torch import obs

CPU = torch.device("cpu")
CUDA = torch.device("cuda")  # a device name only: no card is touched without a profiler
EXPECTED = {
    "probe": {"validate", "keys", "probe", "dedupe", "gather"},
    "multiprobe": {"validate", "keys", "probe", "dedupe", "gather"},
    "exact": {"validate", "scan"},
}


def _index(device="cpu"):
    cfg = tapi.IndexConfig(d=8, M=8, K=6, L=8, max_candidates=32,
                           space=tapi.BoundedSpace(0, 1, 8))
    x = np.random.default_rng(0).uniform(0, 1, (2048, 8)).astype(np.float32)
    q = torch.from_numpy(x[:16] + 0.01).to(device)
    w = torch.ones((16, 8), device=device)
    return tapi.Index.build(0, x, cfg, device=device), q, w


def _spans(prof):
    """The profiler's host events as (name, start ns, end ns)."""
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CPU]


class _Refused:
    def __init__(self, *args, **kwargs):
        raise AssertionError("made with no profiler recording")


def test_without_a_profiler_every_span_is_the_shared_noop(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    before = obs.stage_ms()
    assert obs.span("query") is obs._NOOP
    assert obs.stage("keys", CPU) is obs._NOOP
    assert obs.stage("keys", CUDA) is obs._NOOP
    with obs.stage("keys", CUDA), obs.span("query"):
        pass
    assert obs.stage_ms() == before and not obs._pending


@pytest.mark.parametrize("mode", ["probe", "multiprobe", "exact"])
def test_untraced_query_records_nothing(monkeypatch, mode):
    index, q, w = _index()
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    monkeypatch.setattr(torch.profiler, "record_function", _Refused)
    res = index.query(q, w, tapi.QuerySpec(k=3, mode=mode))
    assert res.ids.shape == (16, 3) and not obs._pending


@pytest.mark.parametrize("mode", ["probe", "multiprobe", "exact"])
def test_traced_query_nests_its_spans_on_the_callers_clock(mode):
    index, q, w = _index()
    spec = tapi.QuerySpec(k=3, mode=mode)
    index.query(q, w, spec)  # warm
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.outer"):
            index.query(q, w, spec)
    spans = _spans(prof)
    (outer,) = [s for s in spans if s[0] == "test.outer"]
    ours = [s for s in spans if s[0].startswith(obs.PREFIX)]
    (query,) = [s for s in ours if s[0] == "repro_torch.query"]
    inner = {s[0][len(obs.PREFIX):] for s in ours} - {"query"}
    assert inner == EXPECTED[mode]
    assert outer[1] <= query[1] and query[2] <= outer[2]
    for _, start, end in ours:
        assert query[1] <= start <= end <= query[2]


class _FakeEvent:
    """A timing event that reads 1.5 ms from any start to its end."""

    def __init__(self, enable_timing=False):
        assert enable_timing

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


def test_a_new_session_replaces_the_last_sessions_records(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with obs.span("warm-up"):  # no profiler: the next recorded stage starts afresh
        pass
    with torch.profiler.profile(activities=acts):
        for _ in range(2):
            with obs.stage("keys", CUDA):
                pass
        with obs.stage("gather", CUDA):
            pass
    assert obs.stage_ms() == {"keys": (3.0, 2), "gather": (1.5, 1)}
    with obs.span("query"):  # untraced, between the sessions
        pass
    with torch.profiler.profile(activities=acts):
        with obs.stage("keys", CUDA):
            pass
    assert obs.stage_ms() == {"keys": (1.5, 1)}


@pytest.mark.cuda
def test_stage_ms_times_each_stage_of_a_probe_query_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    index, q, w = _index("cuda")
    spec = tapi.QuerySpec(k=3)
    index.query(q, w, spec)  # warm, untraced
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        index.query(q, w, spec)
    got = obs.stage_ms()
    assert set(got) == {"keys", "probe", "dedupe", "gather"}
    for ms, calls in got.values():
        assert ms > 0 and calls == 1


@pytest.mark.parametrize("alpha", [0.0, 2.0])
def test_the_proxy_screen_is_a_stage_of_its_own(monkeypatch, alpha):
    """On int8 storage the proxy screen (alpha > 0) runs in ``screen`` and
    the exact rerank alone in ``gather``; without a screen only ``gather``
    is recorded. Each gather call is marked to see which stage it ran in."""
    from repro_torch.engine import pipeline

    cfg = tapi.IndexConfig(d=8, M=8, K=6, L=8, max_candidates=32,
                           space=tapi.BoundedSpace(0, 1, 8), storage="int8")
    x = np.random.default_rng(0).uniform(0, 1, (2048, 8)).astype(np.float32)
    index = tapi.Index.build(0, x, cfg, device="cpu")
    q, w = torch.from_numpy(x[:16] + 0.01), torch.ones((16, 8))
    spec = tapi.QuerySpec(k=3, screen_alpha=alpha)
    real = pipeline.ops.gather_rerank_topk

    def marked(*args, **kwargs):
        with torch.profiler.record_function("test.gather_call"):
            return real(*args, **kwargs)

    monkeypatch.setattr(pipeline.ops, "gather_rerank_topk", marked)
    index.query(q, w, spec)  # warm
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        index.query(q, w, spec)
    spans = _spans(prof)
    stages = {s[0][len(obs.PREFIX):]: s for s in spans
              if s[0] in (obs.PREFIX + "screen", obs.PREFIX + "gather")}
    assert set(stages) == ({"screen", "gather"} if alpha else {"gather"})
    calls = [s for s in spans if s[0] == "test.gather_call"]
    assert len(calls) == len(stages)
    for name, (_, start, end) in stages.items():
        inside = [c for c in calls if start <= c[1] and c[2] <= end]
        assert len(inside) == 1, name
    if alpha:
        assert stages["screen"][2] <= stages["gather"][1]
