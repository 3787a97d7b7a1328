"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, the metrics.

The system under test is ``repro_torch.api.Index``: built once by
``Index.build(seed, rows, IndexConfig, device)``, then driven by one client
in a closed loop, ``Index.query`` on batch after batch from a pool drawn
from the seed, each batch ending when its ids, distances and candidate
counts are in host memory. Nothing else of the program is called.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import math
import subprocess
import sys
import time

import numpy as np
import torch

from portbench import bench, compare
from portbench.trace import WINDOW_SPAN, Trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of the run's seed."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or ``names``) whose top-level name is a forbidden one,
    compared whole."""
    return sorted(m for m in list(sys.modules if names is None else names)
                  if m.split(".")[0] in FORBIDDEN)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Inputs:
    """What the seed makes: the rows, the pool of query batches, the index
    seed, and the queries of each batch the comparison reads."""

    def __init__(self, cell: bench.Cell, seed: int, device):
        cfg, tr = cell.config, cell.traffic
        self.n, self.d, self.k = int(cfg["rows"]), int(cfg["dim"]), int(cfg["k"])
        self.b = int(tr["batch"])
        gen = cell.module("datagen", cfg["data"]["generator"])
        self.data = gen.make(cfg["data"], self.n, self.d, derive(seed, "rows"), device)
        self.pool = [self.data.batch(self.b, derive(seed, f"batch{j}"))
                     for j in range(int(tr["pool"]))]
        self.rows = self.data.rows
        self.data = None  # the pool is drawn: keep only the rows
        self.index_seed = derive(seed, "index")
        sample = tr.get("check_sample")
        self.checked = []
        for j in range(len(self.pool)):
            if sample is None:
                self.checked.append(None)
            else:
                g = torch.Generator().manual_seed(derive(seed, f"sample{j}"))
                self.checked.append(torch.sort(torch.randperm(self.b, generator=g)[:sample]).values)


def index_config(config: dict):
    import repro_torch.api as tapi

    ix = config["index"]
    lo, hi, t = (float(v) for v in ix["space"])
    return tapi.IndexConfig(d=int(config["dim"]), M=int(ix["M"]), K=int(ix["K"]), L=int(ix["L"]),
                            family=ix["family"], W=float(ix["W"]),
                            max_candidates=int(ix["max_candidates"]),
                            space=tapi.BoundedSpace(lo, hi, t), storage=ix["storage"])


def query_spec(config: dict, traffic: dict):
    import repro_torch.api as tapi

    return tapi.QuerySpec(k=int(config["k"]), mode=traffic["mode"],
                          n_probes=int(traffic.get("n_probes", 8)),
                          max_flips=int(traffic.get("max_flips", 3)))


def probes(config: dict, traffic: dict) -> int:
    """Probe keys a table: 1, or the multiprobe count clamped to the
    subsets of at most ``max_flips`` of K bits."""
    if traffic["mode"] != "multiprobe":
        return 1
    K, flips = int(config["index"]["K"]), int(traffic["max_flips"])
    return min(int(traffic["n_probes"]), sum(math.comb(K, r) for r in range(flips + 1)))


class Client:
    """The one client: fetches each answer into host buffers it holds
    (page-locked on a card), so that a batch ends when its ids, distances
    and candidate counts are in host memory, and keeps per pool batch each
    distinct answer it was given, with how often."""

    def __init__(self, n_pool: int, device):
        self.device = device
        self.buffers = [None] * n_pool
        self.answers = [[] for _ in range(n_pool)]  # per pool batch: [answer, times]

    def fetch(self, j: int, res):
        """Answer ``res`` of pool batch ``j`` in host memory, in buffers
        that the next answer of ``j`` overwrites."""
        parts = (res.ids, res.dists, res.n_candidates)
        if self.buffers[j] is None:
            pin = self.device.type == "cuda"
            self.buffers[j] = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                                    for t in parts)
        for src, dst in zip(parts, self.buffers[j]):
            dst.copy_(src, non_blocking=True)
        sync(self.device)
        return self.buffers[j]

    def keep(self, j: int, ans) -> None:
        """Count answer ``ans`` of pool batch ``j`` (numpy compares a few
        times faster than torch on one host thread)."""
        for seen in self.answers[j]:
            if all(np.array_equal(a.numpy(), b.numpy()) for a, b in zip(seen[0], ans)):
                seen[1] += 1
                return
        self.answers[j].append([tuple(a.clone() for a in ans), 1])


def window(index, pool, spec, seconds: float, tracing: bool, client: Client):
    """Closed loop, one client, batch after batch from the pool in turn,
    until ``seconds`` have passed; returns (walls, pool index of each
    batch, window seconds). The client keeps each answer while the card
    works on the next batch."""
    span = torch.profiler.record_function if tracing else (lambda _: contextlib.nullcontext())
    walls, order = [], []
    gc.disable()  # no collection pause inside the window
    try:
        with span(WINDOW_SPAN):
            begin = time.perf_counter()
            deadline = begin + seconds
            i = 0
            last = None
            while True:
                j = i % len(pool)
                q, w = pool[j]
                t0 = time.perf_counter()
                with span("portbench.facade"):
                    res = index.query(q, w, spec)
                with span("portbench.client"):
                    if last is not None:
                        client.keep(*last)
                    last = (j, client.fetch(j, res))
                t1 = time.perf_counter()
                walls.append(t1 - t0)
                order.append(j)
                i += 1
                if t1 >= deadline:
                    break
            client.keep(*last)
    finally:
        gc.enable()
    return walls, order, t1 - begin


def reference_side(ref, inputs: Inputs, config: dict, traffic: dict):
    """Per pool batch: the reference's k distances and candidate counts for
    the checked queries, and the batch's valid and distinct candidate slots."""
    mode = traffic["mode"]
    out = []
    for j, (q, w) in enumerate(inputs.pool):
        rows = inputs.checked[j]
        qs, ws = (q, w) if rows is None else (q[rows.to(q.device)], w[rows.to(q.device)])
        if mode == "exact":
            dist, ids = ref.exact(qs, ws, inputs.k)
            out.append(dict(rows=rows, d=dist, i=ids, count=None, valid=None, distinct=None))
            continue
        keys = ref.keys(q, w, probes(config, traffic), int(traffic.get("max_flips", 0)))
        cand, count = ref.candidates(keys)
        valid = cand[cand < ref.n]
        dist, ids = ref.topk(q, w, cand, inputs.k)
        if rows is not None:
            dev_rows = rows.to(q.device)
            dist, ids, count = dist[dev_rows], ids[dev_rows], count[dev_rows]
        out.append(dict(rows=rows, d=dist, i=ids, count=count, valid=int(valid.numel()),
                        distinct=int(torch.unique(valid).numel())))
    return out


def judge(ref, inputs: Inputs, side: list, per_pool: list, with_ncand: bool) -> dict:
    """The comparison's numbers over every answer of ``per_pool``."""
    tally = compare.Tally(with_ncand)
    for j, (q, w) in enumerate(inputs.pool):
        rows = inputs.checked[j]
        qs, ws = (q, w) if rows is None else (q[rows.to(q.device)], w[rows.to(q.device)])
        r = side[j]
        for (ids, dists, ncand), times in per_pool[j]:
            if rows is not None:
                ids, dists, ncand = ids[rows], dists[rows], ncand[rows]
            ids_dev = ids.to(q.device)
            d64 = ref.distances(qs, ws, ids_dev.long())
            miss, gap, ngap = compare.judge_answer(
                ids_dev, dists.to(q.device), ncand.to(q.device), d64, r["d"], r["count"], ref.n)
            tally.add(miss, gap, ngap, times)
    return tally.numbers()


def reference_class(cell: bench.Cell):
    return cell.module("references", cell.config["reference"]).Reference


def control_answers(ctrl, inputs: Inputs, config: dict, traffic: dict):
    """The control's answers (the reference in bfloat16, in the program's
    place), one per pool batch, for the checked queries."""
    per_pool = []
    for j, (q, w) in enumerate(inputs.pool):
        rows = inputs.checked[j]
        if traffic["mode"] == "exact":
            qs, ws = (q, w) if rows is None else (q[rows.to(q.device)], w[rows.to(q.device)])
            dist, ids = ctrl.exact(qs, ws, inputs.k)
            ncand = torch.full((qs.shape[0],), ctrl.n)
        else:
            keys = ctrl.keys(q, w, probes(config, traffic), int(traffic.get("max_flips", 0)))
            cand, ncand = ctrl.candidates(keys)
            dist, ids = ctrl.topk(q, w, cand, inputs.k)
        ans = (ids.int().cpu(), dist.float().cpu(), ncand.int().cpu())
        if rows is not None and traffic["mode"] == "exact":
            full = [torch.full((inputs.b,) + a.shape[1:], v, dtype=a.dtype)
                    for a, v in zip(ans, (-1, math.inf, 0))]
            for f, a in zip(full, ans):
                f[rows] = a
            ans = tuple(full)
        per_pool.append([[ans, 1]])
    return per_pool


class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def device_block(device, peak: int | None) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def power_limit(device) -> str:
    if device.type != "cuda":
        return "no card"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run(cell: bench.Cell, seed: int, seconds: float, tracing: bool, device="cuda",
        t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result object of the last line."""
    import repro_torch.api as tapi

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    cuda = device.type == "cuda"

    inputs = Inputs(cell, seed, device)
    sync(device)
    t0 = time.perf_counter()
    index = tapi.Index.build(inputs.index_seed, inputs.rows, index_config(config), device=device)
    sync(device)
    build_ms = 1e3 * (time.perf_counter() - t0)
    spec = query_spec(config, traffic)
    client = Client(len(inputs.pool), device)
    for j, (q, w) in enumerate(inputs.pool):  # every shape the window uses, every kernel loaded
        client.fetch(j, index.query(q, w, spec))
    gc.collect()
    sync(device)
    build_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    prof = None
    if tracing:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    walls, order, window_s = window(index, inputs.pool, spec, seconds, tracing, client)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    log(f"[portbench] {cell.name} seed={seed}: {len(walls)} batches of {inputs.b} in "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s (build {build_ms:.3f} ms, "
        f"build peak {build_peak} B); card {power_limit(device)}")

    # the comparison: the program's state is freed, the rows drawn again
    del index
    inputs.rows = None
    per_pool = client.answers
    del client
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rows = cell.module("datagen", config["data"]["generator"]).make(
        config["data"], inputs.n, inputs.d, derive(seed, "rows"), device).rows
    ref = reference_class(cell)(rows, inputs.index_seed, inputs.d, config["index"], "f64")
    side = reference_side(ref, inputs, config, traffic)
    numbers = judge(ref, inputs, side, per_pool, traffic["mode"] != "exact")
    correct, checks = compare.verdict(numbers, cell.limits)
    for c in checks.values():
        c["value"] = printable(c["value"])
    log(f"[portbench] reference and comparison {time.perf_counter() - t_ref:.3f} s")

    trace = Trace.from_profiler(prof) if prof is not None else None
    ix = config["index"]
    per_batch = [dict(mode=traffic["mode"], b=inputs.b, d=inputs.d, n=inputs.n, k=inputs.k,
                      K=int(ix["K"]), L=int(ix["L"]), M=int(ix["M"]), C=int(ix["max_candidates"]),
                      P=probes(config, traffic), valid=s["valid"], distinct=s["distinct"])
                 for s in side]
    batches = [per_batch[j] for j in order]
    ctx = Context(cell=cell.name, config=config, traffic=traffic, setup_s=setup_s,
                  build_ms=build_ms, walls=walls, window_s=window_s,
                  queries=inputs.b * len(walls), peak_bytes=peak, trace=trace, batches=batches,
                  counts=bench.counts(), hand_symbols=bench.hand_symbols())
    metrics = {}
    for m in (cell.per_layer if tracing else cell.end_to_end):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_block(device, max(build_peak, peak or 0))
    result = {"correct": correct, "attempted": inputs.b * len(walls), "failed": 0,
              "metrics": metrics, "device": dev}
    if trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    return result


def printable(x):
    """A number JSON can carry: a non-finite reading prints as 1e300."""
    return x if x is None or math.isfinite(x) else 1e300


def control(cell: bench.Cell, seed: int, device="cuda") -> dict:
    """The comparison's numbers for the control: the reference computed in
    bfloat16 answers the pool in the program's place."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    config, traffic = cell.config, cell.traffic
    inputs = Inputs(cell, seed, device)
    Reference = reference_class(cell)
    ctrl = Reference(inputs.rows, inputs.index_seed, inputs.d, config["index"], "bf16")
    per_pool = control_answers(ctrl, inputs, config, traffic)
    del ctrl
    ref = Reference(inputs.rows, inputs.index_seed, inputs.d, config["index"], "f64")
    side = reference_side(ref, inputs, config, traffic)
    numbers = judge(ref, inputs, side, per_pool, traffic["mode"] != "exact")
    correct, checks = compare.verdict(numbers, cell.limits)
    for c in checks.values():
        c["value"] = printable(c["value"])
    return {"correct": correct, "checks": checks}
