"""The readers of the program's own spans on hand-made traces: the idle time
split by layer adds up to the window's idle time, a gap is placed in its
stage span however many host events lie between them, only the syncs made
inside ``repro_torch.query`` count, and a trace with no kernels or no
program spans reads nothing."""

import types

import pytest

from portbench import bench, spans
from portbench.trace import HOST_SCAN, Trace

NEW = ["stage_ms.keys", "stage_ms.probe", "stage_ms.dedupe", "stage_ms.gather", "stage_ms.scan",
       "idle_ms.facade", "idle_ms.engine", "idle_ms.client", "syncs_per_batch"]
IDLE = ["idle_ms.facade", "idle_ms.engine", "idle_ms.client"]


def _read(metric, trace, batches=2):
    ctx = types.SimpleNamespace(trace=trace, batches=[{}] * batches)
    return bench.load_module(bench.PORTBENCH / "metrics" / f"{metric}.py").read(ctx)


def _batch(t0, host_ops=0):
    """One batch from ``t0``: its host spans and syncs, and its kernels.
    Idle: 10 ns in validate, 30 ns in keys (behind ``host_ops`` host events)
    and 20 ns in the query span between two stages."""
    host = [
        ("repro_torch.query", t0, t0 + 400),
        ("repro_torch.validate", t0, t0 + 20),
        ("cudaStreamSynchronize", t0 + 5, t0 + 15),
        ("repro_torch.keys", t0 + 20, t0 + 120),
        ("repro_torch.probe", t0 + 120, t0 + 200),
        ("repro_torch.gather", t0 + 220, t0 + 400),
        ("cudaMemcpyAsync", t0 + 300, t0 + 301),  # not blocking
    ]
    host += [("aten::select", t0 + 21 + i // 10, t0 + 22 + i // 10) for i in range(host_ops)]
    kernels = [("k_validate", t0 + 10, t0 + 20), ("k_keys", t0 + 20, t0 + 70),
               ("k_keys2", t0 + 100, t0 + 200), ("k_gather", t0 + 220, t0 + 400)]
    return host, kernels


def _trace(host_ops=0, client_sync=True):
    host, kernels = [], []
    for t0 in (100, 540):
        h, k = _batch(t0, host_ops)
        host += h
        kernels += k
    if client_sync:
        host.append(("cudaStreamSynchronize", 505, 530))  # the client's fetch, outside a query
    return Trace(kernels, [("Memcpy DtoH", 530, 540)], host, (100, 1000))


@pytest.mark.parametrize("host_ops", [0, 600], ids=["few_host_events", "600_host_events"])
def test_idle_by_layer_adds_up_and_places_each_gap(host_ops):
    trace = _trace(host_ops)
    idle = {m: _read(m, trace) for m in IDLE}
    window_idle_ns = (trace.window[1] - trace.window[0]) - sum(e - s for s, e in trace.busy())
    assert sum(idle.values()) == pytest.approx(window_idle_ns / 1e6 / 2)
    # per batch: 30 ns in keys; 10 in validate and 20 between probe and gather;
    # the client: 500..530 and 940..1000, 90 ns over two batches
    assert idle["idle_ms.engine"] == pytest.approx(30e-6)
    assert idle["idle_ms.facade"] == pytest.approx(30e-6)
    assert idle["idle_ms.client"] == pytest.approx(45e-6)


def test_a_gap_in_a_stage_goes_to_the_engine_behind_more_host_events_than_the_breakdown_scans():
    trace = _trace(host_ops=600)
    assert 600 > HOST_SCAN
    names = dict(trace.idle_gaps())
    assert "repro_torch.keys" not in names  # the breakdown's look-back stops short
    assert _read("idle_ms.engine", trace) == pytest.approx(30e-6)


def test_only_syncs_inside_a_query_count():
    assert _read("syncs_per_batch", _trace(client_sync=True)) == 1
    assert _read("syncs_per_batch", _trace(client_sync=False)) == 1


@pytest.mark.parametrize("metric", NEW)
def test_readers_read_nothing_without_kernels_or_program_spans(monkeypatch, metric):
    from repro_torch import obs

    monkeypatch.setattr(obs, "stage_ms", lambda: {s: (3.0, 2) for s in spans.STAGES})
    host, _ = _batch(100)
    assert _read(metric, None) is None
    assert _read(metric, Trace([], [], host, (100, 1000))) is None
    if metric.startswith("stage_ms."):
        assert _read(metric, _trace()) == pytest.approx(1.5)
    else:
        bare = [h for h in host if not h[0].startswith("repro_torch.")]
        assert _read(metric, Trace([("k", 150, 160)], [], bare, (100, 1000))) is None


def test_a_stage_the_run_did_not_time_reads_nothing(monkeypatch):
    from repro_torch import obs

    monkeypatch.setattr(obs, "stage_ms", lambda: {"keys": (4.0, 2)})
    assert _read("stage_ms.keys", _trace()) == pytest.approx(2.0)
    assert _read("stage_ms.scan", _trace()) is None


def test_every_span_metric_has_one_reader_and_one_entry():
    entries = [m for m in bench.read_json(bench.ROOT / "BENCHMARK.json")["per_layer"]
               if m["source"] == "program_span"]
    assert sorted(m["name"] for m in entries) == sorted(NEW)
    for m in entries:
        assert (bench.PORTBENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] == "qps" and m["better"] == "lower" and m["workloads"]
