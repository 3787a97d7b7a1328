#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --digests    # only alsh_project's output digests
    python3 chip_smoke.py --wl1-times  # only the wl1 kernels' times (see wl1_times)
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py --restart-drill  # only the drill

Phases, each of which fails the run (exit code 1) when it fails:

  1. device: the card's name, the device count, and its name and power
     limit as ``nvidia-smi`` reports them;
  2. build: every CUDA kernel under ``src/repro_torch/kernels/csrc`` is
     compiled with nvcc (one process per source, all started together),
     with the ``-Xptxas -v`` register and shared-memory report;
  3. service set-up, made once and shared by the later phases: the
     ``SERVICE`` configuration's (n=262,144, d=128, M=32, K=12, L=32,
     C=128) near-duplicate clusters (see ``Workload``) and query batch, the
     f32 theta index built over them on the card with ``Index.build`` (one
     more build profiled: device time by kernel and idle share), and the
     batch's deduped probe candidates;
  4. one phase per kernel, at the service widths: the kernel and its plain
     PyTorch version run on the same seeded inputs on the card and must
     agree (tolerances printed with each phase); the kernel's time (CUDA
     events, warmed up), the plain version's time, one PyTorch library
     call's time where one computes the same function, and the least time
     the card could take (bytes over 3.35 TB/s or flops over 67 TFLOP/s
     FP32, whichever is larger; a gather moves each distinct row once).
     The f32 gather runs at four main-path shapes — the service batch's
     candidates (b=1024, P=4096), a streamed early-exit merge's (b=1024,
     P=1034), a stream batch's over two segments (b=1024, P=12,288) and
     the exact mode of a mutable index (two segments, b=64, every id) — and
     at each must also equal, bit for bit, the one-warp-per-query schedule
     on the same inputs (``gather_rerank_topk_warp_cuda``, the reference
     entry of the stored-type source), timed beside it with the number of
     slot splits S the launch used.
     The quantized gather runs four cases — over the service candidates
     int8 with scales (the exact pass), int8 with the proxy query (the
     screen pass) and bf16, and the exact pass over the screen's survivors —
     each on the schedule the host picks (printed), and each must also
     equal, bit for bit, the f32 kernel over the decoded table and the
     one-warp schedule over the payload, both timed beside it (over the
     survivors also as device time per call, from the profiler). The two
     two-segment gathers (f32, and int8 with scales and with the proxy
     query) run over the SERVICE main table plus a delta of 8192
     near-duplicate rows, on a stream batch's deduped candidates from the
     main windows and the delta match; each must also equal, bit for bit,
     its single-segment kernel over ``torch.cat([main, delta])``, and the
     quantized one also the f32 two-segment kernel over the decoded tables
     and the one-warp schedule, all timed beside it. The materializing scan ``wl1_scan`` runs
     at n=65,536 and 262,144 (b=64, d=128) and the re-rank ``wl1_rerank``
     at b=64, d=128, C=512 and 4096, each also on a ragged shape, against
     their plain versions at rtol/atol 1e-4, with the profiler's device
     time per call and its share of the bound, the scan's issue floor
     derived from the SM clock read under load in the run (printed, not
     recorded), and the host time per call of 200 back-to-back calls
     (printed on one line). The
     exact scan ``wl1_scan_topk`` runs at the service batch (n=262,144, b=1024), the
     main path's recall check (b=64) and the recorded shape (n=65,536,
     b=64), and at each must also equal, bit for bit, ``wl1_scan`` then a
     stable sort of each query's distances (the first k, +inf -> id -1),
     with the row splits S it used. ``alsh_project`` (build and query
     width) must return the same bytes from two calls, and prints a
     sha256 of its output's bytes;
  5. main paths, each with every launch counter zeroed just before its
     queries and read just after; a kernel of the path that was never
     launched fails the run:
     a. f32: three probe-mode query batches of 1024 with k=10 on the
        service index, recall@10 against exact mode on the first 64
        queries of each, held to a stated floor; then one l2 build and
        batch at the same widths with bucket width ``L2_W``;
     b. quantized: the same theta index stored as int8 and as bf16 (same
        seed), served at screen α=2 and α=0: ``n_candidates`` must equal
        the f32 index's, recall@10 against the index's own exact mode must
        clear the floor, f32 storage at α=2 must equal α=0, and the
        quantized kernel must launch twice per screened and once per
        unscreened batch;
     c. multiprobe: theta, 8 probes per table, up to 3 flipped bits, on
        the f32 index and batch of a probe batch; its j-th distance is
        never worse than the probe batch's;
     d. stream, in the order of ``serve --mode stream``: the f32 theta
        index built with ``UpdateSpec(delta_capacity=8192,
        compact_threshold=0.75)`` must answer the service batch as the
        sealed index does, bit for bit; then 13 ticks, each inserting 512
        rows (16 jittered copies of 32 new centres), retiring the 128
        oldest main rows, serving a batch of 1024 whose first 32 queries
        sit on the new centres, and checking recall@10 against the mutable
        index's exact mode on the first 64 queries. Every tick: no deleted
        id in a result, a delta id in at least 90% of the first 32
        queries' results, recall over the floor. After tick 12 (fill
        6144) ``needs_compact`` must hold; the compacted index must equal
        ``Index.build`` over the survivors (sorted keys, permutation,
        answers). Then an int8 and an f32 mutable index take two ticks of
        the same operations: equal ``n_candidates``, and the quantized
        two-segment kernel launched twice per screened (α=2) and once per
        unscreened batch;
     e. unfused baseline (``benchmarks/kernels_bench.py``'s): ``wl1_scan``
        then ``torch.topk`` beside ``wl1_scan_topk``, and ``data[ids]``
        then ``wl1_rerank`` then ``torch.topk`` beside
        ``gather_rerank_topk`` on real probe candidates, P=512…4096; the
        two sides' dists must be equal bit for bit (see
        ``phase_unfused_path``);
     f. early exit (see ``phase_early_exit_path``): the streamed query at
        slack 0 equals the monolithic one (sealed f32, mutable, int8 with
        the screen off); at slack 0.1, probe and multiprobe, its batch
        time, windows probed, stop reasons and recall@10 (held to the
        floor); ``Index.explain`` and ``serve --early-exit --stats``;
     g. persistence (see ``phase_persist_path``): ``Index.save`` then
        ``Index.load`` with the default device, at the service width: the
        f32 sealed index, int8 and f32 mutable indexes after two stream
        ticks, a bf16 sealed index; every leaf equal by bits and every
        query bit-equal with equal launch counts (the mutable ones also
        after one more tick and after a compact); the save and load
        seconds and the bytes on disk beside the card's name and power
        limit; a flipped payload byte and a removed COMMIT raise their
        named errors; msgpack and ml_dtypes are never imported;
     h. planning (see ``phase_plan_path``): a ``QualitySpec`` build at the
        service width with the default planner, then one calibrating on
        the workload's weights (its geometry, attempts and seconds, each
        calibration rung's ms), ``query(quality)`` bit-equal to
        ``query(plan)`` with its ms, device time and held-out recall beside
        the explicit SERVICE index's, the ladder and ``explain``, the int8
        index's plan through the blocked gather, the memo through
        save/load (no calibration after the load), the tuner over the
        service's rows inline and on two spawned workers (equal records,
        equal launches) with its table as a prior at the 0.9 target, and
        the candidates per ms the card re-ranks;
     i. serving (see ``phase_broker_path``): a ``QualitySpec`` build at the
        service width with the default planner and its degradation ladder
        (at least two rungs, each rung's held-out recall), each rung timed
        through the ``Broker`` at buckets 1, 8 and 64, a Poisson and a
        bursty trace of 2000 requests at rates derived from rung 0's time,
        a 4-shard ``ShardSet`` whose exact mode equals the single index's,
        and its chaos drill (a shard killed mid-trace, two failed reloads,
        recovery, bit-identical answers after it); no kernel built after
        warmup; then ``alsh_project`` and ``gather_rerank_topk`` timed at
        rung 0's shapes (b=1, b=64, the b=64 calibration batch);
     j. sharded (see ``phase_sharded_path``): 8 x 262,144 clustered rows
        (permuted before the partition) on a (2, 2, 2) mesh of the one
        card, ``Index.shard`` of a single-host index over all of them:
        probe (hierarchical equal to flat merge bit for bit, candidate
        counts the shards' sum, shard 0 equal to a single-host index over
        its rows, recall@10 held to the floor), multiprobe, exact mode
        against the single-host index's, then a mutable index after two
        stream ticks, sharded: exact mode, a lockstep insert, deletes, and
        the sharded compact equal to the single-host compact leaf for leaf;
        the ``Index.shard`` seconds and the sharded and single-host batch
        times beside the card;
     k. static contracts (see ``phase_static_contracts``): the port's tree
        lints clean; ``repro_torch.analysis.audit`` on the card — 146 raw
        lattice points fold to 64 compile keys, every path under the memory
        envelope, no dtype finding, no drift against
        ``golden_budget_cuda.json`` — with each path's tracker and
        allocator bytes and launches; both seeded regressions fail as named
        (AUD001, AUD002); every compile key's answer at the audit geometry
        (two index states, random queries) and the live probe's agree with
        the CPU plain path's; the live normalization probe is bit-equal
        under a ``RetraceGuard``; then the f32 probe, int8 screened, multiprobe,
        exact, stream (tick 12) and streamed early-exit batches at the
        SERVICE widths with their peak bytes (tracker and allocator) and
        host syncs per batch (``torch.cuda.set_sync_debug_mode("warn")``);
     l. lm (see ``phase_lm_path``): full-width gemma3-1b with parameters
        drawn on the card, the prefill of 4 prompts of 64 tokens and 16
        greedy decode steps plain, with ALSH retrieval over 65,536 records
        (``RetrievalConfig()``) and with a growing datastore (one
        ``extend_datastore`` a step): ms per step (median of 3 loops),
        launches per step (one projection and one gather a retrieval step),
        device busy and idle share, the host time's split, peak bytes and
        host syncs of a step, recall@8 against exact mode; then the exact
        lookup and its scan against the plain path, recall on uniform and
        near-duplicate keys, each lookup against the CPU plain path over a
        copy of its datastore (ids equal, kNN log-probs within 1e-5), the
        kernels at the decode shapes against their plain versions, the
        casts of one step alone, the reduced model on the card against the
        CPU (logits 1e-4, tokens equal), and the full-width f32
        prefill/decode gap at S=512 (within 2e-2) and S=600 (printed);
     m. train (see ``phase_train_path``): full-width gemma3-1b under
        ``TrainConfig()`` at S=4096, batch 2 (1 past a 72 GB allocator
        peak): a warm-up and 5 timed steps (ms a step, tokens/s), one
        profiled (busy, idle share, top device ops) and its ATen ops
        counted, the peak, ``adamw_update`` alone, loss and grad norm
        finite beside ln V; 2 steps at microbatch 2 with int8_ef; the
        reduced model's loss, grads and one step on the card against the
        CPU; ``pipeline_apply`` over 4 stages on the card against the
        sequential stages; and the restart drill in a process of its own
        (``--restart-drill``, deterministic): a failure at step 7 and a
        restart from the step-5 commit, async checkpoints, equal to the
        clean run bit for bit, its last commit restored on the CPU leaf
        for leaf. No kernel runs on this path (launches 0);
  6. check: on a small input, the card's answers agree with the plain
     PyTorch path on the CPU over the same index state (f32 probe and
     exact, int8 screened probe).

The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_FLOPS = 67e12  # H100 SXM FP32 outside the tensor cores (data sheet)
DIST_RTOL = DIST_ATOL = 1e-5  # f32 sums over d=128 in different orders
PROJ_ATOL = 2e-3  # |projection| <~ 100, 128 f32 terms: rounding <~ 128 * 2**-24 * 100
SEED = 0
# Workload: the near-duplicate clusters of benchmarks/earlyexit_bench.py at
# the service width. n rows in clusters of CLUSTER around centres drawn
# uniform in [0.1, 0.9]^d, jitter SIGMA; queries sit on cluster centres, so
# each query's true top-10 is its own cluster; weights 1 + 0.1 |N(0, 1)|.
CLUSTER = 16
SIGMA = 1e-3
THETA_RECALL_FLOOR = 0.5  # mean probe recall@10 over a batch's first 64 queries
L2_W = 64.0  # l2 bucket width of the l2 batch (the projections' scale; see PERF.md)
L2_RECALL_FLOOR = 0.5
QUANT_RECALL_FLOOR = 0.5  # recall@10 of a quantized batch against its own exact mode
SCREEN_ALPHA = 2.0  # the serve CLI's default --screen-alpha
SURVIVOR_CALLS = 20  # calls profiled for the device time of the exact pass over the survivors

KERNEL_META = {
    "alsh_project": ("src/repro_torch/kernels/csrc/alsh_project.cu",
                     "src/repro/kernels/alsh_project.py:103"),
    "gather_rerank_topk": ("src/repro_torch/kernels/csrc/gather_rerank.cu",
                           "src/repro/kernels/gather_rerank.py:365"),
    "gather_rerank_topk_blocked": ("src/repro_torch/kernels/csrc/gather_rerank_blocked.cu",
                                   "src/repro/kernels/gather_rerank.py:288"),
    "wl1_scan_topk": ("src/repro_torch/kernels/csrc/wl1_topk.cu",
                      "src/repro/kernels/wl1_topk.py:132"),
    "gather_rerank_topk_two_seg": ("src/repro_torch/kernels/csrc/gather_rerank.cu",
                                   "src/repro/kernels/gather_rerank.py:111"),
    "gather_rerank_topk_blocked_two_seg": ("src/repro_torch/kernels/csrc/gather_rerank_blocked.cu",
                                           "src/repro/kernels/gather_rerank.py:187"),
    "wl1_scan": ("src/repro_torch/kernels/csrc/wl1_distance.cu",
                 "src/repro/kernels/wl1_distance.py:66"),
    "wl1_rerank": ("src/repro_torch/kernels/csrc/wl1_distance.cu",
                   "src/repro/kernels/wl1_distance.py:112"),
}
PATHS = ("f32", "quantized", "multiprobe", "stream", "unfused", "early_exit", "persist", "plan",
         "broker", "sharded", "static_contracts", "lm", "train")
# The stream path: the reference service's defaults (serve --mode stream)
STREAM_CAP = 8192  # --delta-capacity
STREAM_THRESHOLD = 0.75  # --compact-threshold
STREAM_INGEST = 512  # --ingest: 32 new centres x CLUSTER copies per tick
STREAM_RETIRE = 128  # --retire
STREAM_TICKS = 13  # the 12th reaches the threshold; the 13th runs after the compact
STREAM_ON_NEW = 32  # queries of a stream batch that sit on the tick's new centres
STREAM_HIT_FLOOR = 0.9  # share of those that must return a delta id
# The materializing scan and re-rank: the reference's own bar
# (tests/test_kernels_wl1.py); both sum in another order than the plain version
WL1_RTOL = WL1_ATOL = 1e-4
# Their device time per call: the profiler over WL1_CALLS back-to-back calls;
# their host cost per call: the host clock over HOST_CALLS calls, no sync
WL1_CALLS = 20
HOST_CALLS = 200
# The unfused baseline of benchmarks/kernels_bench.py (its shapes)
BASELINE_N, BASELINE_B, BASELINE_K = 65536, 64, 10
BASELINE_P = (512, 1024, 2048, 4096)
# Early exit: serve's --exit-group and --exit-slack defaults
EXIT_GROUP = 8
EXIT_SLACK = 0.1
# Quality-first planning: the target the plan path builds from, the held-out
# queries its recall is measured on, and the tuner's workers
PLAN_K, PLAN_RECALL = 10, 0.9
PLAN_HELD_OUT = 64
TUNE_WORKERS = 2
# The tuner's weight skew for the service's weights: |N(0,1)|**0.05 + 0.1
# spans ~[1.0, 1.13], as 1 + 0.1 |N(0,1)| spans ~[1.0, 1.16]
PLAN_SKEW = 0.05
# The broker path: serve --mode broker's batch and queue bounds, the buckets
# each rung is timed at (median of BROKER_REPS), the traces' length, the
# shard count and the arrival at which the chaos drill kills shard 1
BROKER_MAX_BATCH, BROKER_MAX_QUEUE = 64, 256
BROKER_TARGETS = (PLAN_RECALL, 0.95, 0.99)  # raised while the ladder has one rung
BROKER_BUCKETS = (1, 8, 64)
BROKER_REPS = 5
BROKER_REQUESTS = 2000
BROKER_SHARDS = 4
BROKER_KILL_AT = 500
# The sharded path: the reference's (2, 2, 2) mesh, all eight shards on the
# one card, SERVICE.n_per_shard rows each; the mutable index's delta and its
# two stream ticks
SHARD_MESH = (2, 2, 2)
SHARD_AXES = ("pod", "data", "model")
SHARD_CAP = 8 * 1024
SHARD_TICKS = 2
SHARD_CHECK = 64  # queries of the exact and recall checks


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, iters: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def clock_under_load(fn, seconds: float = 0.6) -> str:
    """``nvidia-smi``'s SM clock and power draw, read while ``fn`` runs back
    to back on the card for about ``seconds`` (launches queued first)."""
    import torch

    reps = max(1, int(seconds * 1e3 / max(time_ms(fn, iters=2), 1e-3)))
    for _ in range(reps):
        fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    torch.cuda.synchronize()
    return smi.stdout.strip().splitlines()[0]


def device_us_per_call(label, fn, calls: int = WL1_CALLS):
    """The profiler's device time of one call of ``fn``, over ``calls``
    back-to-back calls (None when not measured)."""
    busy = profile(f"{label}, {calls} calls", lambda: [fn() for _ in range(calls)], top=2)
    return None if busy is None else busy / calls


def host_us_per_call(fn, calls: int = HOST_CALLS) -> float:
    """Host clock per call over ``calls`` back-to-back calls with no sync
    between them (warmed up; the device may still be busy at the end)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def issue_floor_us(terms: int, clock: str):
    """The scan's issue floor, derived from the SM clock that ``nvidia-smi``
    read under load in this run (``clock``, as ``clock_under_load`` returns
    it): two FP32 instructions (a subtract, an |.|-multiply-add) per
    (query, row, coordinate) term, one warp instruction per clock on each
    of an SM's 4 schedulers. None when the clock is not a number."""
    import torch

    try:
        mhz = float(clock.split(" MHz")[0])
    except ValueError:
        return None
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 2 * terms / (sms * 128 * mhz * 1e6) * 1e6


class Run:
    def __init__(self):
        self.failures: list[str] = []
        self.kernels: dict[str, dict] = {}

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:  # a failed phase fails the run; later phases still report
            traceback.print_exc(file=sys.stdout)
            self.failures.append(name)
            print(f"== {name}: FAILED", flush=True)
            return None
        print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)
        return out

    def record(self, name, **numbers):
        src, replaces = KERNEL_META[name]
        entry = self.kernels.setdefault(
            name, {"name": name, "route": "cuda", "source": src, "replaces": replaces}
        )
        entry.update(numbers)


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name}; count: {count}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return {"kind": name, "count": count, "card": card}


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    kernels = _build.build_all()
    print(f"nvcc {' '.join(_build.NVCC_FLAGS)}: all sources in {time.perf_counter() - t0:.1f} s")
    shown = set()
    for k in kernels.values():
        if k.source in shown:  # a source's two-segment entries share its build
            continue
        shown.add(k.source)
        secs = "cached" if k.build_seconds is None else f"{k.build_seconds:.1f} s"
        print(f"  {k.source}: {secs}")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"    {line.strip()}")


class Workload:
    """The clustered rows (n, d) on the card and their cluster centres;
    :meth:`batch` draws a query batch on the centres from its own seed."""

    def __init__(self, n: int, d: int, seed: int = SEED):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.centres = torch.rand((n // CLUSTER, d), generator=gen, device="cuda") * 0.8 + 0.1
        jitter = SIGMA * torch.randn((n // CLUSTER, CLUSTER, d), generator=gen, device="cuda")
        self.data = (self.centres[:, None, :] + jitter).reshape(-1, d).contiguous()

    def batch(self, b: int, seed: int):
        import torch

        gen = torch.Generator(device="cuda").manual_seed(seed)
        c, d = self.centres.shape
        pick = torch.randperm(c, generator=gen, device="cuda")[:b]
        q = self.centres[pick] + SIGMA * torch.randn((b, d), generator=gen, device="cuda")
        w = 1.0 + 0.1 * torch.randn((b, d), generator=gen, device="cuda").abs()
        return q.contiguous(), w.contiguous()


class Service:
    """What the SERVICE phases share, made once: the clustered workload
    ``wl``, the service batch ``q``/``w``, the f32 theta ``index`` over the
    rows, and the batch's deduped probe candidates ``cand`` (b, L*C) =
    (1024, 4096) with their ``valid`` slot count and ``distinct`` row count."""

    def __init__(self):
        import torch

        import repro_torch.api as tapi
        from repro_torch.configs.paper_alsh import SERVICE
        from repro_torch.core.index import _dedupe_candidates
        from repro_torch.engine.pipeline import probe_keys, sources_for

        cfg = SERVICE.index_config
        self.wl = Workload(SERVICE.n_per_shard, SERVICE.d)
        self.q, self.w = self.wl.batch(SERVICE.query_batch, SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.index = tapi.Index.build(SEED + 2, self.wl.data, cfg)
        torch.cuda.synchronize()
        print(f"  [theta] built the f32 index over n={self.index.n} d={cfg.d} K={cfg.K} "
              f"L={cfg.L} C={cfg.max_candidates} on {self.index.device} in "
              f"{time.perf_counter() - t0:.3f} s")
        profile("of one Index.build (SERVICE)",
                lambda: tapi.Index.build(SEED + 2, self.wl.data, cfg), unprofiled_wall=True)
        keys = probe_keys(self.index.state, self.q, self.w, cfg)
        cand = sources_for(self.index.state, None, None, cfg, keys)[0].emit(self.q, self.w)
        self.cand, n_cand = _dedupe_candidates(cand, self.index.n)
        self.valid = int(n_cand.sum())
        self.distinct = distinct_rows(self.cand, self.index.n)
        print(f"  candidates: ids {tuple(self.cand.shape)}, {self.valid} valid "
              f"({self.valid / self.cand.shape[0]:.1f} per query), {self.distinct} distinct rows")


def stream_rows(seed: int, n_centres: int, d: int):
    """``n_centres`` new centres uniform in [0.1, 0.9]^d and CLUSTER copies
    of each jittered by SIGMA (the ``Workload`` recipe), drawn on the card."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    centres = torch.rand((n_centres, d), generator=gen, device="cuda") * 0.8 + 0.1
    jitter = SIGMA * torch.randn((n_centres, CLUSTER, d), generator=gen, device="cuda")
    return centres, (centres[:, None, :] + jitter).reshape(-1, d).contiguous()


def stream_batch(wl, centres, seed: int):
    """A service batch whose first ``len(centres)`` queries sit on the given
    (new) centres, jittered as ``Workload.batch`` jitters its queries."""
    import torch

    from repro_torch.configs.paper_alsh import SERVICE

    q, w = wl.batch(SERVICE.query_batch, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    m = centres.shape[0]
    q[:m] = centres + SIGMA * torch.randn(centres.shape, generator=gen, device="cuda")
    return q.contiguous(), w


class TwoSegment:
    """The two-segment kernels' inputs: the SERVICE main table, a full delta
    of STREAM_CAP rows (near-duplicates of 512 new centres) inserted into
    the service index with ``delta_insert``, and a stream batch's deduped
    candidates from the main windows plus the delta match."""

    def __init__(self, svc):
        import torch

        from repro_torch.configs.paper_alsh import SERVICE
        from repro_torch.core.index import DeltaSegment, _dedupe_candidates, delta_insert
        from repro_torch.engine.pipeline import probe_keys, sources_for

        cfg = SERVICE.index_config
        state = svc.index.state
        n, d = state.data.shape
        self.n_tot = n + STREAM_CAP
        centres, rows = stream_rows(SEED + 50, STREAM_CAP // CLUSTER, d)
        delta = DeltaSegment.empty(cfg, STREAM_CAP, torch.float32, state.device)
        self.delta, _ = delta_insert(state, delta, rows, cfg)
        self.q, self.w = stream_batch(svc.wl, centres[:STREAM_ON_NEW], SEED + 51)
        tomb = torch.zeros((self.n_tot,), dtype=torch.bool, device=state.device)
        keys = probe_keys(state, self.q, self.w, cfg)
        srcs = sources_for(state, self.delta, tomb, cfg, keys)
        cand = torch.cat([s.emit(self.q, self.w) for s in srcs], dim=1)
        self.cand, n_cand = _dedupe_candidates(cand, self.n_tot)
        self.valid = int(n_cand.sum())
        in_delta = int(((self.cand >= n) & (self.cand < self.n_tot)).sum())
        print(f"  two-segment candidates: ids {tuple(self.cand.shape)} over main n={n} + delta "
              f"cap={STREAM_CAP}, {self.valid} valid ({self.valid / self.cand.shape[0]:.1f} per "
              f"query, {in_delta} in the delta), "
              f"{distinct_rows(self.cand, self.n_tot)} distinct rows")


def distinct_rows(ids, n: int) -> int:
    """The number of distinct valid ids (< n) in ``ids``."""
    import torch

    return int(torch.unique(ids[ids < n]).numel())


def gather_bound(ids, n: int, d: int, k: int, row_bytes: int, scaled: bool):
    """The least time of one fused gather/rerank/top-k over ``ids`` (b, P):
    each distinct valid row read once at its stored width, the ids, q and w
    (and the scales) read once, the (b, k) outputs written once; 3 flops per
    coordinate of every valid (query, row) pair (a subtract and a fused
    multiply-add, the |.| a free operand modifier), 4 with the decode's
    multiply. Also returns the bytes the queries gather row by row, which
    the L2 serves beyond the distinct rows (not part of the bound)."""
    b = ids.shape[0]
    nv = int((ids < n).sum())
    nbytes = (distinct_rows(ids, n) * d * row_bytes + 4 * ids.numel() + 4 * 2 * b * d
              + 8 * b * k + (4 * d if scaled else 0))
    flops = (4 if scaled else 3) * nv * d
    return (*bound(nbytes, flops), nbytes, flops, nv * d * row_bytes)


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def projection_digests() -> dict:
    """``alsh_project``'s output digests at build and query width on the
    inputs ``phase_alsh_project`` uses, through ``ops.alsh_project(levels,
    folded, weights)`` alone, so that the same file run beside an older tree
    of the repository (``python3 chip_smoke.py --digests``) compares two
    trees' kernels byte for byte."""
    import torch

    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.core import hash_families as hf
    from repro_torch.core.transforms import discretize
    from repro_torch.kernels import ops

    cfg = SERVICE.index_config
    wl = Workload(SERVICE.n_per_shard, SERVICE.d)
    q, w = wl.batch(SERVICE.query_batch, SEED + 1)
    tables = hf.make_prefix_tables(torch.Generator().manual_seed(SEED), cfg.lsh_params)
    folded = tables.folded.to(wl.data.device).contiguous()
    return {label: digest(ops.alsh_project(levels, folded, weights))
            for label, levels, weights in (("build", discretize(wl.data, cfg.space), None),
                                           ("query", discretize(q, cfg.space), w))}


def wl1_times() -> dict:
    """CUDA-event time, device time per call (the profiler over WL1_CALLS
    back-to-back calls) and host time per call (``host_us_per_call``) of
    ``wl1_scan`` and ``wl1_rerank`` at the shapes of their phases, the
    host time of the parts of one ``ops.wl1_rerank`` call at C=512
    (``rerank_host_parts``), and the two times of ``wl1_scan_topk`` at the
    three scan shapes, through ``ops`` alone, so that the same file run
    beside an older tree of the repository (``python3 chip_smoke.py
    --wl1-times``) times both trees' kernels with one method."""
    import torch

    from repro_torch.kernels import ops

    def times(label, fn, host=False):
        out = {"ms": time_ms(fn, iters=10, warmup=2), "device_us": device_us_per_call(label, fn)}
        if host:
            out["host_us"] = host_us_per_call(fn)
        return out

    out = {}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    for n in (BASELINE_N, 262144):
        data, q, w = (torch.randn(s, generator=gen, device="cuda")
                      for s in ((n, 128), (BASELINE_B, 128), (BASELINE_B, 128)))
        out[f"wl1_scan n={n}"] = times(f"wl1_scan n={n}", lambda: ops.wl1_scan(data, q, w),
                                       host=True)
    for C in (512, 4096):
        pts, q, w = (torch.randn(s, generator=gen, device="cuda")
                     for s in ((BASELINE_B, C, 128), (BASELINE_B, 128), (BASELINE_B, 128)))
        out[f"wl1_rerank C={C}"] = times(f"wl1_rerank C={C}", lambda: ops.wl1_rerank(pts, q, w),
                                         host=True)
        if C == 512:
            out["wl1_rerank C=512 host parts"] = rerank_host_parts(pts, q, w)
    wl = Workload(262144, 128)
    q, w = wl.batch(1024, SEED + 1)
    for label, n, b in (("service", 262144, 1024), ("main", 262144, 64),
                        ("recorded", BASELINE_N, 64)):
        dn, qb, wb = wl.data[:n].contiguous(), q[:b].contiguous(), w[:b].contiguous()
        out[f"wl1_scan_topk {label}"] = times(f"wl1_scan_topk {label}",
                                              lambda: ops.wl1_scan_topk(dn, qb, wb, 10))
    return out


def rerank_host_parts(pts, q, w) -> dict:
    """Host us per call of the parts of one ``ops.wl1_rerank`` call, each
    timed alone like ``host_us_per_call``: the three argument checks, the
    output allocation, and the launch through ``ctypes`` (outside the
    wrapper, so not counted; its error code checked)."""
    import torch

    from repro_torch.kernels._build import WL1_RERANK, require

    dev = pts.device
    b, C, d = pts.shape
    lib = WL1_RERANK.lib()
    out = torch.empty((b, C), dtype=torch.float32, device=dev)
    ptrs = (pts.data_ptr(), q.data_ptr(), w.data_ptr(), out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        WL1_RERANK.check(lib.wl1_rerank_launch(*ptrs, b, C, d, stream), "wl1_rerank launch")

    parts = {
        "argument checks": lambda: [require(t, "t", torch.float32, t.ndim, dev)
                                    for t in (pts, q, w)],
        "output allocation": lambda: torch.empty((b, C), dtype=torch.float32, device=dev),
        "ctypes launch": launch,
    }
    return {name: host_us_per_call(fn) for name, fn in parts.items()}


def phase_alsh_project(run, svc):
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.core import hash_families as hf
    from repro_torch.core.transforms import discretize
    from repro_torch.kernels import ops

    cfg = SERVICE.index_config
    data, q, w = svc.wl.data, svc.q, svc.w
    tables = hf.make_prefix_tables(torch.Generator().manual_seed(SEED), cfg.lsh_params).to(data.device)
    folded, tiled = tables.folded.contiguous(), tables.tiled
    H, d, m1 = folded.shape
    for label, levels, weights in (
        ("build", discretize(data, cfg.space), None),
        ("query", discretize(q, cfg.space), w),
    ):
        n = levels.shape[0]

        def kernel():
            return ops.alsh_project(levels, folded, weights, tiled=tiled)

        got = kernel()
        want = ops.alsh_project(levels, folded, weights, force="plain")
        again = kernel()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        far = want.abs() > PROJ_ATOL  # theta codes are compared away from 0 only
        flips = int(((got >= 0) != (want >= 0))[far].sum())
        same = torch.equal(got.view(torch.int32), again.view(torch.int32))
        sha = digest(got)
        print(f"  {label}: levels ({n}, {d}) x folded ({H}, {d}, {m1})"
              f"{' weighted' if weights is not None else ''}: max_abs_err={err:.3g} "
              f"(atol {PROJ_ATOL}); theta-code flips away from 0: {flips} "
              f"({int((~far).sum())} projections within atol of 0); two calls identical "
              f"bytes: {same}; sha256 of the output bytes {sha}")
        if err > PROJ_ATOL or flips:
            raise AssertionError(f"alsh_project {label}: kernel disagrees with the plain version")
        if not same:
            raise AssertionError(f"alsh_project {label}: two calls returned different bytes")
        del again
        ms = time_ms(kernel, iters=10, warmup=2)
        plain_ms = time_ms(lambda: ops.alsh_project(levels, folded, weights, force="plain"),
                           iters=1)
        dev_us = profile(f"alsh_project {label}", kernel, top=2)
        clock = clock_under_load(kernel) if label == "build" else None
        if clock:
            print(f"  {label}: SM clock, power under a stream of calls: {clock}")
        # library yardstick: the TPU kernel's own formulation, a one-hot
        # (n, d*(M+1)) x (d*(M+1), H) f32 product (one-hot built outside the timing)
        onehot = F.one_hot(levels.long(), m1).float()
        if weights is not None:
            onehot = onehot * weights[..., None]
        lhs = onehot.reshape(n, d * m1)
        rhs = folded.permute(1, 2, 0).reshape(d * m1, H).contiguous()
        torch.backends.cuda.matmul.allow_tf32 = False
        lib_ms = time_ms(lambda: torch.matmul(lhs, rhs), iters=5, warmup=1)
        del onehot, lhs
        nbytes = 4 * (n * d * (2 if weights is not None else 1) + H * d * m1 + n * H)
        flops = n * H * d * (2 if weights is not None else 1)
        b_ms, b_by = bound(nbytes, flops)
        print(f"  {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, one-hot matmul "
              f"{lib_ms:.4f} ms; bound {b_ms * 1e3:.1f} us by {b_by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        dev_ms = None if dev_us is None else dev_us / 1e3
        if label == "build":  # the JSON line reports the build-width call
            run.record("alsh_project", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, device_ms=dev_ms,
                       sha256=sha, clock_under_load=clock)
        else:
            run.kernels["alsh_project"]["query_shape"] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "library_ms": lib_ms,
                "max_abs_err": err, "device_ms": dev_ms, "sha256": sha,
            }


def _check_topk(label, got, want, data, q, w, quiet=False):
    import torch

    from repro_torch.kernels.ref import unexplained_id_mismatches

    gd, gi = got
    wd, wi = want
    fin = torch.isfinite(wd)
    if not bool((torch.isfinite(gd) == fin).all()):
        raise AssertionError(f"{label}: found/not-found slots differ")
    err = float((gd[fin] - wd[fin]).abs().max()) if bool(fin.any()) else 0.0
    tol_ok = bool(((gd[fin] - wd[fin]).abs() <= DIST_ATOL + DIST_RTOL * wd[fin].abs()).all())
    ties = int((gi != wi).sum())
    bad = unexplained_id_mismatches(gi, wd, wi, data, q, w, rtol=DIST_RTOL, atol=DIST_ATOL)
    if not quiet or not tol_ok or bad:
        print(f"  {label}: max_abs_err={err:.3g} (rtol/atol {DIST_RTOL}); id mismatches "
              f"{ties}, of which not genuine ties: {bad}")
    if not tol_ok or bad:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return err


def _f32_gather_case(label, data, ids, q, w, k, delta=None, iters=10, old_iters=10):
    """The f32 kernel at one main-path shape: against its plain version, bit
    for bit against the one-warp-per-query schedule on the same inputs
    (``gather_rerank_topk_warp_cuda``; a difference fails the run), and
    timed beside both."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_rerank import f32_splits, gather_rerank_topk_warp_cuda

    b, P = ids.shape
    d = data.shape[1]
    S = f32_splits(data, ids, delta)

    def kernel():
        return ops.gather_rerank_topk(data, ids, q, w, k, delta=delta)

    def old():
        return gather_rerank_topk_warp_cuda(data, ids, q, w, k, delta=delta)

    got = kernel()
    want = ops.gather_rerank_topk(data, ids, q, w, k, delta=delta, force="plain")
    torch.cuda.synchronize()
    table = data if delta is None else torch.cat([data, delta])
    err = _check_topk(f"{label}: kernel vs plain", got, want, table, q, w)
    ref = old()
    bitwise = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    print(f"  {label}: bit-equal to the one-warp-per-query schedule: {bitwise}")
    if not bitwise:
        raise AssertionError(f"{label}: differs from the one-warp-per-query schedule")
    del table, ref
    ms = time_ms(kernel, iters=iters, warmup=2)
    old_ms = time_ms(old, iters=old_iters, warmup=1)
    plain_ms = time_ms(lambda: ops.gather_rerank_topk(data, ids, q, w, k, delta=delta,
                                                      force="plain"), iters=1)
    n_tot = data.shape[0] + (0 if delta is None else delta.shape[0])
    b_ms, b_by, nbytes, flops, l2_bytes = gather_bound(ids, n_tot, d, k, 4, scaled=False)
    nv, nd = int(((ids >= 0) & (ids < n_tot)).sum()), distinct_rows(ids, n_tot)
    print(f"  {label}: ids {tuple(ids.shape)}, {nv / b:.1f} valid per query, {nd} distinct rows; "
          f"S={S}; kernel {ms:.4f} ms, one-warp schedule {old_ms:.4f} ms "
          f"({old_ms / ms:.2f}x), plain {plain_ms:.4f} ms, library: none; bound "
          f"{b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
          f"rows gathered per query, served by HBM or L2: {l2_bytes / 1e6:.1f} MB")
    return {"b": b, "P": P, "k": k, "splits": S, "valid_ids": nv, "distinct_rows": nd,
            "max_abs_err": err, "ms": ms, "old_schedule_ms": old_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def streamed_merge_ids(svc):
    """The candidate block of the last per-group merge of a streamed
    early-exit batch on the service index (slack 0, so every group runs):
    the heap's ids and one group's windows, deduped — (1024, k + 8·128)."""
    import dataclasses

    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import ops

    seen = []
    group_entry = ops.gather_rerank_topk_group

    def spy(data, ids, *args, **kwargs):
        seen.append(ids)
        return group_entry(data, ids, *args, **kwargs)

    spec = dataclasses.replace(tapi.QuerySpec(k=SERVICE.topk), early_exit=True,
                               exit_group=EXIT_GROUP, exit_slack=0.0)
    ops.gather_rerank_topk_group = spy
    try:
        svc.index.query(svc.q, svc.w, spec)
    finally:
        ops.gather_rerank_topk_group = group_entry
    return seen[-1]


def phase_gather_rerank(run, svc):
    """The f32 kernel at the service batch's candidates (b=1024, P=4096) and
    at a streamed early-exit merge's (b=1024, P=1034)."""
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import ops

    data, q, w, k = svc.wl.data, svc.q, svc.w, SERVICE.topk
    shapes = {"service": _f32_gather_case("service batch", data, svc.cand, q, w, k)}
    profile("gather_rerank_topk", lambda: ops.gather_rerank_topk(data, svc.cand, q, w, k), top=2)
    merge = streamed_merge_ids(svc)
    shapes["streamed_merge"] = _f32_gather_case("streamed merge", data, merge, q, w, k)
    main = shapes["service"]
    run.record("gather_rerank_topk", max_abs_err=main["max_abs_err"], ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None, splits=main["splits"], old_schedule_ms=main["old_schedule_ms"],
               shapes=shapes)


def _schedule(payload, ids, scales, delta=None) -> tuple[int, str]:
    """The stored-type kernel's schedule for these inputs, as the wrapper
    picks it, and how it reads."""
    from repro_torch.kernels.gather_rerank import WARP_SCHEDULE, stored_schedule

    S = stored_schedule(payload, ids, scales, delta)
    return S, ("one warp per query" if S == WARP_SCHEDULE else f"split, S={S}")


def _same_bits(label, got, ref, what):
    """Fails the run unless ``got`` equals ``ref`` bit for bit."""
    import torch

    bitwise = torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    print(f"  {label}: bit-equal to {what}: {bitwise}")
    if not bitwise:
        raise AssertionError(f"{label}: differs from {what}")


def phase_gather_rerank_blocked(run, svc):
    import torch

    from repro_torch import quant
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_rerank import (
        gather_rerank_topk_cuda,
        gather_rerank_topk_warp_cuda,
    )

    data, q, w, cand = svc.wl.data, svc.q, svc.w, svc.cand
    (n, d), P = data.shape, cand.shape[1]
    k = SERVICE.topk
    p8, s8 = quant.get_codec("int8").encode(data)
    pb, _ = quant.get_codec("bf16").encode(data)
    qp, wp = quant.proxy_query(q, w, p8.dtype, s8)
    keep = quant.screen_keep(k, SCREEN_ALPHA, P)
    # the survivors of the screen pass, -1 mapped to the sentinel, are the
    # exact pass's candidates on the screened main path
    _, surv = ops.gather_rerank_topk(p8, cand, qp, wp, keep)
    surv = torch.where(surv >= 0, surv, torch.full_like(surv, n))
    cases = (
        ("int8, scales: exact pass over all candidates", p8, s8, cand, q, w, k),
        (f"int8, proxy q/w: screen pass keeping {keep}", p8, None, cand, qp, wp, keep),
        ("bf16: over all candidates", pb, None, cand, q, w, k),
        (f"int8, scales: exact pass over the {keep} survivors", p8, s8, surv, q, w, k),
    )
    out = {}
    for label, payload, scales, ids, qq, ww, kk in cases:
        def kernel():
            return ops.gather_rerank_topk(payload, ids, qq, ww, kk, scales=scales)

        def one_warp():
            return gather_rerank_topk_warp_cuda(payload, ids, qq, ww, kk, scales=scales)

        S, sched = _schedule(payload, ids, scales)
        got = kernel()
        want = ops.gather_rerank_topk(payload, ids, qq, ww, kk, scales=scales, force="plain")
        torch.cuda.synchronize()
        decoded = quant.decode_table(payload, scales)
        err = _check_topk(label, got, want, decoded, qq, ww)
        _same_bits(label, got, gather_rerank_topk_cuda(decoded.contiguous(), ids, qq, ww, kk),
                   "the f32 kernel (its split schedule) over the decoded table")
        _same_bits(label, got, one_warp(), "the one-warp-per-query schedule")
        ms = time_ms(kernel, iters=10, warmup=2)
        warp_ms = time_ms(one_warp, iters=10, warmup=1)
        plain_ms = time_ms(
            lambda: ops.gather_rerank_topk(payload, ids, qq, ww, kk, scales=scales,
                                           force="plain"), iters=1)
        f32_ms = time_ms(lambda: gather_rerank_topk_cuda(decoded, ids, qq, ww, kk), iters=10,
                         warmup=1)
        b_ms, b_by, nbytes, flops, l2_bytes = gather_bound(
            ids, n, d, kk, payload.element_size(), scaled=scales is not None)
        nv, nd = int((ids < n).sum()), distinct_rows(ids, n)
        print(f"  {label}: ids {tuple(ids.shape)}, {nv} valid, {nd} distinct rows; {sched}; "
              f"kernel {ms:.4f} ms, one-warp schedule {warp_ms:.4f} ms ({warp_ms / ms:.2f}x), "
              f"f32 kernel over the decoded table {f32_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library: none; bound {b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.3f} GFLOP); rows gathered per query, served by HBM or L2: "
              f"{l2_bytes / 1e6:.1f} MB")
        out[label] = {"ids_shape": list(ids.shape), "valid_ids": nv, "distinct_rows": nd,
                      "k": kk, "splits": S,
                      "max_abs_err": err, "ms": ms, "old_schedule_ms": warp_ms,
                      "plain_ms": plain_ms, "f32_ms": f32_ms,
                      "bound_ms": b_ms, "bound_by": b_by}
    profile("gather_rerank_topk_blocked (int8 screen pass)",
            lambda: ops.gather_rerank_topk(p8, cand, qp, wp, keep), top=2)
    # at 20 survivors per query the events time holds host time between
    # launches; the profiler's device time of SURVIVOR_CALLS calls separates
    # the two
    decoded8 = quant.decode_table(p8, s8)
    survivors = out[cases[3][0]]
    for key, label, fn in (
        ("device_us", "gather_rerank_topk_blocked (int8 exact pass over the survivors)",
         lambda: ops.gather_rerank_topk(p8, surv, q, w, k, scales=s8)),
        ("old_schedule_device_us", "one-warp schedule (int8 exact pass over the survivors)",
         lambda: gather_rerank_topk_warp_cuda(p8, surv, q, w, k, scales=s8)),
        ("f32_device_us", "gather_rerank_topk (f32 over the decoded survivors)",
         lambda: gather_rerank_topk_cuda(decoded8, surv, q, w, k)),
    ):
        busy = profile(f"{label}, {SURVIVOR_CALLS} calls",
                       lambda: [fn() for _ in range(SURVIVOR_CALLS)], top=2)
        survivors[key] = None if busy is None else busy / SURVIVOR_CALLS
        if busy is not None:
            print(f"  {label}: device time per call {busy / SURVIVOR_CALLS:.2f} us")
    main = out[cases[0][0]]
    run.record("gather_rerank_topk_blocked", max_abs_err=main["max_abs_err"], ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
               library_ms=None, splits=main["splits"], old_schedule_ms=main["old_schedule_ms"],
               cases=out)


def phase_gather_rerank_two_seg(run, svc, seg):
    """The f32 two-segment kernel over the SERVICE main table and a full
    delta: at a stream batch's candidates (b=1024, P=12,288) and at the
    exact mode of a mutable index (b=64, every id of both segments, from
    ``ExhaustiveSource``); against its plain version, the one-warp schedule,
    and the single-segment kernel over the concatenated table (bit for
    bit)."""
    import torch

    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.engine.sources import ExhaustiveSource
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_rerank import gather_rerank_topk_cuda

    main, delta, q, w, cand = svc.wl.data, seg.delta.data, seg.q, seg.w, seg.cand
    k = SERVICE.topk
    cat = torch.cat([main, delta])
    got = ops.gather_rerank_topk(main, cand, q, w, k, delta=delta)
    single = gather_rerank_topk_cuda(cat, cand, q, w, k)
    bitwise = torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])
    print(f"  bit-equal to the single-segment kernel over torch.cat([main, delta]): {bitwise}")
    if not bitwise:
        raise AssertionError("two-segment kernel differs from the concatenated-table kernel")
    single_ms = time_ms(lambda: gather_rerank_topk_cuda(cat, cand, q, w, k), iters=10, warmup=1)
    print(f"  single-segment kernel over the concatenated table {single_ms:.4f} ms")
    del cat, got, single
    shapes = {"stream_batch": _f32_gather_case("stream batch", main, cand, q, w, k, delta=delta)}
    profile("gather_rerank_topk_two_seg",
            lambda: ops.gather_rerank_topk(main, cand, q, w, k, delta=delta), top=2)
    tomb = torch.zeros((seg.n_tot,), dtype=torch.bool, device=main.device)
    qx, wx = q[:64].contiguous(), w[:64].contiguous()  # the stream path's exact check
    ex = ExhaustiveSource(svc.index.state, seg.delta, tomb).emit(qx, wx)
    shapes["exhaustive"] = _f32_gather_case("exact mode of a mutable index", main, ex, qx, wx, k,
                                            delta=delta, iters=5, old_iters=2)
    profile("gather_rerank_topk_two_seg (exact mode)",
            lambda: ops.gather_rerank_topk(main, ex, qx, wx, k, delta=delta), top=3)
    main_case = shapes["stream_batch"]
    run.record("gather_rerank_topk_two_seg", max_abs_err=main_case["max_abs_err"],
               ms=main_case["ms"], plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
               bound_by=main_case["bound_by"], library_ms=None, splits=main_case["splits"],
               old_schedule_ms=main_case["old_schedule_ms"], single_segment_ms=single_ms,
               shapes=shapes)


def phase_gather_rerank_blocked_two_seg(run, svc, seg):
    """The quantized two-segment kernel: int8 with scales (the exact pass)
    and int8 with the proxy query (the screen pass) over the int8 main
    table and the delta encoded with its scales; against the plain version
    and, bit for bit, the single-segment kernel over the concatenated
    payload, the f32 two-segment kernel over the decoded tables and the
    one-warp schedule, each timed beside it."""
    import torch

    from repro_torch import quant
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_rerank import (
        gather_rerank_topk_blocked_cuda,
        gather_rerank_topk_cuda,
        gather_rerank_topk_warp_cuda,
    )

    main, q, w, cand = svc.wl.data, seg.q, seg.w, seg.cand
    d, P, k = main.shape[1], cand.shape[1], SERVICE.topk
    codec = quant.get_codec("int8")
    p8, s8 = codec.encode(main)
    d8 = codec.encode_rows(seg.delta.data, s8)  # the delta keeps the sealed scales
    cat8 = torch.cat([p8, d8])
    qp, wp = quant.proxy_query(q, w, p8.dtype, s8)
    keep = quant.screen_keep(k, SCREEN_ALPHA, P)
    out = {}
    for label, scales, qq, ww, kk in (
        ("int8, scales: exact pass over all candidates", s8, q, w, k),
        (f"int8, proxy q/w: screen pass keeping {keep}", None, qp, wp, keep),
    ):
        dec_main = quant.decode_table(p8, scales).contiguous()
        dec_delta = quant.decode_table(d8, scales).contiguous()

        def kernel():
            return ops.gather_rerank_topk(p8, cand, qq, ww, kk, scales=scales, delta=d8)

        def one_warp():
            return gather_rerank_topk_warp_cuda(p8, cand, qq, ww, kk, scales=scales, delta=d8)

        def f32():
            return gather_rerank_topk_cuda(dec_main, cand, qq, ww, kk, delta=dec_delta)

        S, sched = _schedule(p8, cand, scales, d8)
        got = kernel()
        want = ops.gather_rerank_topk(p8, cand, qq, ww, kk, scales=scales, delta=d8,
                                      force="plain")
        torch.cuda.synchronize()
        err = _check_topk(label, got, want, quant.decode_table(cat8, scales), qq, ww)
        _same_bits(label, got, gather_rerank_topk_blocked_cuda(cat8, cand, qq, ww, kk,
                                                               scales=scales),
                   "the single-segment kernel over torch.cat([main, delta])")
        _same_bits(label, got, f32(), "the f32 two-segment kernel over the decoded tables")
        _same_bits(label, got, one_warp(), "the one-warp-per-query schedule")
        ms = time_ms(kernel, iters=10, warmup=2)
        warp_ms = time_ms(one_warp, iters=10, warmup=1)
        f32_ms = time_ms(f32, iters=10, warmup=1)
        plain_ms = time_ms(lambda: ops.gather_rerank_topk(p8, cand, qq, ww, kk, scales=scales,
                                                          delta=d8, force="plain"), iters=1)
        single_ms = time_ms(lambda: gather_rerank_topk_blocked_cuda(cat8, cand, qq, ww, kk,
                                                                    scales=scales),
                            iters=10, warmup=1)
        b_ms, b_by, nbytes, flops, l2_bytes = gather_bound(cand, seg.n_tot, d, kk, 1,
                                                           scaled=scales is not None)
        print(f"  {label}: {sched}; kernel {ms:.4f} ms, one-warp schedule {warp_ms:.4f} ms "
              f"({warp_ms / ms:.2f}x), single-segment kernel over the concatenated payload "
              f"{single_ms:.4f} ms, f32 two-segment kernel over the decoded tables "
              f"{f32_ms:.4f} ms, plain {plain_ms:.4f} ms, library: none; bound "
              f"{b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP); "
              f"rows gathered per query, served by HBM or L2: {l2_bytes / 1e6:.1f} MB")
        out[label] = {"k": kk, "splits": S, "max_abs_err": err, "ms": ms,
                      "old_schedule_ms": warp_ms, "plain_ms": plain_ms,
                      "single_segment_ms": single_ms, "f32_ms": f32_ms, "bound_ms": b_ms,
                      "bound_by": b_by}
        del dec_main, dec_delta
    profile("gather_rerank_topk_blocked_two_seg (int8 screen pass)",
            lambda: ops.gather_rerank_topk(p8, cand, qp, wp, keep, delta=d8), top=2)
    main_case = next(iter(out.values()))
    run.record("gather_rerank_topk_blocked_two_seg", max_abs_err=main_case["max_abs_err"],
               ms=main_case["ms"], plain_ms=main_case["plain_ms"],
               bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"], library_ms=None,
               splits=main_case["splits"], old_schedule_ms=main_case["old_schedule_ms"],
               cases=out)


def sorted_scan_topk(data, q, w, k):
    """The first k of ``wl1_scan``'s distances under a stable sort, (+inf,
    -1) past the finite ones: what ``wl1_scan_topk`` must return bit for bit."""
    import torch

    from repro_torch.kernels import ops

    dists = ops.wl1_scan(data, q, w)
    sd, order = torch.sort(dists, dim=1, stable=True)
    del dists
    kk = min(k, sd.shape[1])
    out_d = torch.full((q.shape[0], k), float("inf"), device=data.device)
    out_i = torch.full((q.shape[0], k), -1, dtype=torch.int32, device=data.device)
    out_d[:, :kk] = sd[:, :kk]
    out_i[:, :kk] = order[:, :kk].to(torch.int32)
    out_i[~torch.isfinite(out_d)] = -1
    return out_d, out_i


def phase_scan(run, svc):
    import torch

    from repro_torch.kernels import ops
    from repro_torch.kernels.wl1_topk import scan_splits

    data, q, w = svc.wl.data, svc.q, svc.w
    k = 10
    sms = torch.cuda.get_device_properties(data.device).multi_processor_count
    # service: exact mode on a full batch; main: the main path's recall check
    # (exact mode on a batch's first 64 queries); recorded: the repo's kernel shape
    for label, n, b in (("service", data.shape[0], q.shape[0]), ("main", data.shape[0], 64),
                        ("recorded", 65536, 64)):
        dn, qb, wb = data[:n].contiguous(), q[:b].contiguous(), w[:b].contiguous()
        d = dn.shape[1]
        got = ops.wl1_scan_topk(dn, qb, wb, k)
        want = ops.wl1_scan_topk(dn, qb, wb, k, force="plain")
        torch.cuda.synchronize()
        err = _check_topk(f"wl1_scan_topk {label} n={n} b={b}", got, want, dn, qb, wb)
        sd, si = sorted_scan_topk(dn, qb, wb, k)
        bitwise = torch.equal(got[0], sd) and torch.equal(got[1], si)
        print(f"  wl1_scan_topk {label}: bit-equal to wl1_scan + stable sort: {bitwise}")
        if not bitwise:
            raise AssertionError(f"wl1_scan_topk {label}: differs from wl1_scan + stable sort")
        del sd, si
        S = scan_splits(n, b, k, sms)
        ms = time_ms(lambda: ops.wl1_scan_topk(dn, qb, wb, k), iters=5, warmup=2)
        plain_ms = time_ms(lambda: ops.wl1_scan_topk(dn, qb, wb, k, force="plain"), iters=1)
        dev_us = profile(f"wl1_scan_topk {label}", lambda: ops.wl1_scan_topk(dn, qb, wb, k),
                         top=3)
        clock = None
        if label == "service":
            clock = clock_under_load(lambda: ops.wl1_scan_topk(dn, qb, wb, k))
            print(f"  {label}: SM clock, power under a stream of calls: {clock}")
        nbytes = 4 * (n * d + 2 * b * d) + 8 * b * k
        flops = 3 * b * n * d
        b_ms, b_by = bound(nbytes, flops)
        print(f"  {label}: S={S}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library: none; "
              f"bound {b_ms * 1e3:.1f} us by {b_by} ({nbytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.1f} GFLOP)")
        numbers = {"n": n, "b": b, "splits": S, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": b_ms, "max_abs_err": err,
                   "device_ms": None if dev_us is None else dev_us / 1e3}
        if label == "service":
            run.record("wl1_scan_topk", max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by, library_ms=None, splits=S,
                       device_ms=numbers["device_ms"], clock_under_load=clock)
        else:
            run.kernels["wl1_scan_topk"][f"{label}_shape"] = numbers
    torch.cuda.empty_cache()  # the stable-sort check's ~4 GB stays out of the later phases


def _wl1_check(label, got, want):
    """Elementwise agreement of a materializing kernel with its plain version."""
    import torch

    diff = (got - want).abs()
    err = float(diff.max())
    ok = bool((diff <= WL1_ATOL + WL1_RTOL * want.abs()).all()) and bool(torch.isfinite(got).all())
    print(f"  {label}: max_abs_err={err:.3g} (rtol/atol {WL1_RTOL})")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return err


def _share(us, of_us):
    """``of_us`` over a measured device time ``us`` (None when either is)."""
    return None if us is None or of_us is None else of_us / us


def _fmt_us(us) -> str:
    return "not measured" if us is None else f"{us:.2f} us"


def _fmt_share(x) -> str:
    return "not measured" if x is None else f"{x:.3f}"


def phase_wl1_scan(run):
    """The materializing scan against its plain version: the recorded shape
    of benchmarks/kernels_bench.py (n=65,536, b=64, d=128; normal data,
    queries and weights, so weights are negative too), the service width
    (n=262,144) and a ragged shape (n, b and d not multiples of 32)."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    for label, n, b, d in (("recorded", BASELINE_N, BASELINE_B, 128), ("service", 262144, 64, 128),
                           ("ragged", 5003, 37, 130)):
        data, q, w = (torch.randn(s, generator=gen, device="cuda") for s in ((n, d), (b, d), (b, d)))
        got = ops.wl1_scan(data, q, w)
        want = ops.wl1_scan(data, q, w, force="plain")
        torch.cuda.synchronize()
        err = _wl1_check(f"wl1_scan {label} n={n} b={b} d={d}", got, want)
        if label == "ragged":
            continue
        ms = time_ms(lambda: ops.wl1_scan(data, q, w), iters=10, warmup=2)
        plain_ms = time_ms(lambda: ops.wl1_scan(data, q, w, force="plain"), iters=1)
        dev_us = device_us_per_call(f"wl1_scan {label}", lambda: ops.wl1_scan(data, q, w))
        nbytes = 4 * (n * d + 2 * b * d + b * n)
        flops = 3 * b * n * d
        b_ms, b_by = bound(nbytes, flops)
        numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, device_us=dev_us,
                       share_of_bound=_share(dev_us, b_ms * 1e3))
        clock = clock_under_load(lambda: ops.wl1_scan(data, q, w))
        floor_us = issue_floor_us(b * n * d, clock)
        print(f"  {label}: kernel {ms:.4f} ms (device {_fmt_us(dev_us)} per call), plain "
              f"{plain_ms:.4f} ms, library: none; bound {b_ms * 1e3:.1f} us by {b_by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); device share of bound "
              f"{_fmt_share(numbers['share_of_bound'])}")
        print(f"  {label}: SM clock, power under a stream of calls: {clock}; issue floor derived "
              f"from that clock {_fmt_us(floor_us)} (2 FP32 instructions a term), device share "
              f"of it {_fmt_share(_share(dev_us, floor_us))}")
        if label == "recorded":
            numbers["host_us_per_call"] = host_us_per_call(lambda: ops.wl1_scan(data, q, w))
            run.record("wl1_scan", **numbers)
        else:
            run.kernels["wl1_scan"][f"{label}_shape"] = {"n": n, "b": b, **numbers}


def phase_wl1_rerank(run):
    """The candidate re-rank against its plain version at b=64, d=128 over
    C=512 (the recorded shape) and C=4096 candidates per query, normal
    points, queries and weights; and a ragged shape."""
    import torch

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    for label, b, C, d in (("recorded", BASELINE_B, 512, 128), ("C=4096", BASELINE_B, 4096, 128),
                           ("ragged", 37, 515, 130)):
        pts, q, w = (torch.randn(s, generator=gen, device="cuda")
                     for s in ((b, C, d), (b, d), (b, d)))
        got = ops.wl1_rerank(pts, q, w)
        want = ops.wl1_rerank(pts, q, w, force="plain")
        torch.cuda.synchronize()
        err = _wl1_check(f"wl1_rerank {label} b={b} C={C} d={d}", got, want)
        if label == "ragged":
            continue
        ms = time_ms(lambda: ops.wl1_rerank(pts, q, w), iters=10, warmup=2)
        plain_ms = time_ms(lambda: ops.wl1_rerank(pts, q, w, force="plain"), iters=1)
        dev_us = device_us_per_call(f"wl1_rerank {label}", lambda: ops.wl1_rerank(pts, q, w))
        nbytes = 4 * (b * C * d + 2 * b * d + b * C)
        flops = 3 * b * C * d
        b_ms, b_by = bound(nbytes, flops)
        # C=512's 16.8 MB stay in the L2 between calls here, so it can beat
        # the bound (every point read once from HBM)
        numbers = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                       library_ms=None, device_us=dev_us,
                       share_of_bound=_share(dev_us, b_ms * 1e3))
        print(f"  {label}: kernel {ms:.4f} ms (device {_fmt_us(dev_us)} per call), plain "
              f"{plain_ms:.4f} ms, library: none; bound {b_ms * 1e3:.1f} us by {b_by} "
              f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); device share of bound "
              f"{_fmt_share(numbers['share_of_bound'])}")
        if label == "recorded":
            numbers["host_us_per_call"] = host_us_per_call(lambda: ops.wl1_rerank(pts, q, w))
            run.record("wl1_rerank", **numbers)
            scan = run.kernels.get("wl1_scan", {})
            print(f"  host per call ({HOST_CALLS} back-to-back calls, no sync): ops.wl1_rerank "
                  f"{numbers['host_us_per_call']:.1f} us (device {_fmt_us(dev_us)}); "
                  f"ops.wl1_scan {scan.get('host_us_per_call', float('nan')):.1f} us (device "
                  f"{_fmt_us(scan.get('device_us'))})")
        else:
            run.kernels["wl1_rerank"]["C4096_shape"] = {"C": C, **numbers}


def _timed_query(index, q, w, spec):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = index.query(q, w, spec)
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def _median_ms(index, q, w, spec, reps: int = 5) -> float:
    """Median host-clock time of ``reps`` warm calls of one batch."""
    times = sorted(_timed_query(index, q, w, spec)[1] for _ in range(reps))
    return times[reps // 2]


def _check_result(res, b, k):
    import torch

    if tuple(res.ids.shape) != (b, k):
        raise AssertionError("result shape")
    if not bool((torch.isfinite(res.dists) == (res.ids >= 0)).all()):
        raise AssertionError("ids == -1 must coincide with dists == +inf")
    if not bool((res.dists[:, 1:] >= res.dists[:, :-1]).all()):
        raise AssertionError("dists must ascend")


def _serve(family: str, batches: int, wl, index=None, **overrides):
    import dataclasses

    import torch

    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k

    if index is None:
        cfg = dataclasses.replace(SERVICE.index_config, family=family, **overrides)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = tapi.Index.build(SEED + 2, wl.data, cfg)
        torch.cuda.synchronize()
        print(f"  [{family}] built index over n={index.n} d={cfg.d} K={cfg.K} L={cfg.L} "
              f"C={cfg.max_candidates} W={cfg.W} on {index.device} in "
              f"{time.perf_counter() - t0:.3f} s")
    spec = tapi.QuerySpec(k=SERVICE.topk)
    exact = tapi.QuerySpec(k=SERVICE.topk, mode="exact")
    out = []
    for bi in range(batches):
        q, w = wl.batch(SERVICE.query_batch, SEED + 100 + bi)
        res, ms = _timed_query(index, q, w, spec)
        dt = ms / 1e3
        ref = index.query(q[:64], w[:64], exact)
        rec = recall_at_k(res.ids[:64], ref.ids, SERVICE.topk)
        cand_frac = float(res.n_candidates.float().mean()) / index.n
        print(f"  [{family}] batch {bi}: {SERVICE.query_batch} queries in {dt * 1e3:.2f} ms "
              f"({dt / SERVICE.query_batch * 1e6:.2f} us/query) cand_frac={cand_frac:.5f} "
              f"recall@{SERVICE.topk}={rec:.3f}")
        _check_result(res, SERVICE.query_batch, SERVICE.topk)
        if not bool((res.dists[:64] >= ref.dists - 1e-4).all()):
            raise AssertionError("a probe result beat the exact scan")
        out.append({"ms": dt * 1e3, "cand_frac": cand_frac, "recall": rec})
    return index, q, w, out


def profile(label, fn, top=12, unprofiled_wall=False, into=None):
    """Print device time by kernel and the device's idle share over one
    call of ``fn`` (torch.profiler; diagnostics, the run does not depend on
    them) and return the device busy time in us (None when not measured).
    With ``unprofiled_wall`` the same call is first timed without the
    profiler, and the idle share is also estimated against that wall time.
    A dict ``into`` receives the walls and the ``top`` rows (name, device
    us, count)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    plain_wall_us = None
    if unprofiled_wall:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall_us = (time.perf_counter() - t0) * 1e6
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        # device-side rows only: a CPU op's row repeats its kernels' device time
        rows = [e for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]
    except Exception as e:  # diagnostics only: a profiler fault must not fail the run
        print(f"  profile {label}: not measured ({type(e).__name__}: {e})")
        return None
    busy_us = sum(e.self_device_time_total for e in rows)
    if busy_us == 0:
        print(f"  profile {label}: no device time recorded (not measured)")
        return None
    print(f"  profile {label}: wall {wall_us:.0f} us (profiler on), device busy {busy_us:.0f} us, "
          f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}")
    if plain_wall_us is not None:
        print(f"  profile {label}: the same call without the profiler just before: wall "
              f"{plain_wall_us:.0f} us; estimated idle share (profiled busy / unprofiled wall) "
              f"{max(0.0, 1 - busy_us / plain_wall_us):.3f}")
    ranked = sorted(rows, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        print(f"    {e.self_device_time_total:9.1f} us  x{e.count:<4d} {e.key[:90]}")
    if into is not None:
        into.update(wall_us=wall_us, unprofiled_wall_us=plain_wall_us, busy_us=busy_us,
                    top=[(e.key[:120], e.self_device_time_total, e.count) for e in ranked])
    return busy_us


def _path_counts(label, needed):
    """The launch counts since the last reset; fails when a kernel of the
    path was never launched."""
    from repro_torch.kernels import _build

    counts = _build.launch_counts()
    print(f"  launches on the {label} path: {counts}")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {label} path: {missing}")
    return counts


def phase_main_path(svc):
    import repro_torch.api as tapi
    from repro_torch.kernels import _build

    wl = svc.wl
    _build.reset_launch_counts()
    index, q, w, theta = _serve("theta", 3, wl, index=svc.index)
    profile("of one theta probe batch", lambda: index.query(q, w, tapi.QuerySpec(k=10)),
            unprofiled_wall=True)
    *_, l2 = _serve("l2", 1, wl, W=L2_W)
    counts = _path_counts("f32", ("alsh_project", "gather_rerank_topk", "wl1_scan_topk"))
    for family, rows, floor in (("theta", theta, THETA_RECALL_FLOOR), ("l2", l2, L2_RECALL_FLOOR)):
        rec = sum(r["recall"] for r in rows) / len(rows)
        print(f"  [{family}] mean recall@10 {rec:.3f} (floor {floor})")
        if rec < floor:
            raise AssertionError(f"{family} probe recall@10 {rec:.3f} is under its floor {floor}")
    return counts, {"theta": theta, "l2": l2}


def phase_quant_path(svc):
    """Quantized storage at the SERVICE widths: int8 and bf16 indexes built
    from the f32 index's seed, served screened (α=2) and unscreened beside
    the f32 index."""
    import dataclasses

    import torch

    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    wl, f32, cfg = svc.wl, svc.index, svc.index.config
    k, b = SERVICE.topk, SERVICE.query_batch
    exact = tapi.QuerySpec(k=k, mode="exact")
    q, w = wl.batch(b, SEED + 100)  # the f32 path's first batch
    _build.reset_launch_counts()
    plain, _ = _timed_query(f32, q, w, tapi.QuerySpec(k=k))
    folded, _ = _timed_query(f32, q, w, tapi.QuerySpec(k=k, screen_alpha=SCREEN_ALPHA))
    f32_ms = _median_ms(f32, q, w, tapi.QuerySpec(k=k))
    print(f"  [f32] the same batch: {f32_ms:.2f} ms (median of 5 warm calls)")
    same = bool((plain.ids == folded.ids).all()) and bool((plain.dists == folded.dists).all())
    print(f"  [f32] alpha={SCREEN_ALPHA} equals alpha=0 (ids and dists): {same}")
    if not same:
        raise AssertionError("f32 storage with screen_alpha > 0 must equal alpha = 0")
    oracle = f32.query(q[:64], w[:64], exact)
    rows = {}
    for storage in ("int8", "bf16"):
        t0 = time.perf_counter()
        index = tapi.Index.build(SEED + 2, wl.data, dataclasses.replace(cfg, storage=storage))
        torch.cuda.synchronize()
        print(f"  [{storage}] built in {time.perf_counter() - t0:.3f} s; table_bytes "
              f"{index.table_bytes} ({f32.table_bytes / index.table_bytes:.2f}x smaller than f32)")
        own = index.query(q[:64], w[:64], exact)
        for alpha in (SCREEN_ALPHA, 0.0):
            spec = tapi.QuerySpec(k=k, screen_alpha=alpha)
            before = _build.launch_counts()["gather_rerank_topk_blocked"]
            res, _ = _timed_query(index, q, w, spec)
            launched = _build.launch_counts()["gather_rerank_topk_blocked"] - before
            ms = _median_ms(index, q, w, spec)
            _check_result(res, b, k)
            same_cand = bool((res.n_candidates == plain.n_candidates).all())
            rec_own = recall_at_k(res.ids[:64], own.ids, k)
            rec_f32 = recall_at_k(res.ids[:64], oracle.ids, k)
            cand_frac = float(res.n_candidates.float().mean()) / index.n
            print(f"  [{storage}] alpha={alpha}: {b} queries in {ms:.2f} ms (median of 5 warm; "
                  f"{ms / b * 1e3:.2f} us/query) cand_frac={cand_frac:.5f} (equal to f32's: "
                  f"{same_cand}) recall@{k} vs own exact {rec_own:.3f}, vs f32 exact "
                  f"{rec_f32:.3f}; quantized-kernel launches {launched}")
            if not same_cand:
                raise AssertionError(f"{storage}: n_candidates differ from the f32 index's")
            if rec_own < QUANT_RECALL_FLOOR:
                raise AssertionError(f"{storage} alpha={alpha}: recall@{k} {rec_own:.3f} is "
                                     f"under its floor {QUANT_RECALL_FLOOR}")
            if launched != (2 if alpha else 1):
                raise AssertionError(f"{storage} alpha={alpha}: {launched} quantized-kernel "
                                     f"launches, expected {2 if alpha else 1}")
            rows[f"{storage}/alpha={alpha}"] = {"ms": ms, "cand_frac": cand_frac,
                                                "recall_own": rec_own, "recall_f32": rec_f32}
        if storage == "int8":
            profile("of one int8 screened batch",
                    lambda: index.query(q, w, tapi.QuerySpec(k=k, screen_alpha=SCREEN_ALPHA)),
                    unprofiled_wall=True)
    # f32 timed again after the quantized batches: f32, quantized, f32 in turns
    rows["f32_ms"] = [f32_ms, _median_ms(f32, q, w, tapi.QuerySpec(k=k))]
    print(f"  [f32] the same batch again: {rows['f32_ms'][1]:.2f} ms (median of 5 warm calls)")
    counts = _path_counts("quantized", ("alsh_project", "gather_rerank_topk_blocked",
                                        "wl1_scan_topk"))
    return counts, rows


def phase_multiprobe_path(svc):
    """Theta multiprobe (the QuerySpec defaults: 8 probes, up to 3 flipped
    bits) on the f32 SERVICE index and the batch of a probe batch."""
    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    index = svc.index
    k, b = SERVICE.topk, SERVICE.query_batch
    q, w = svc.wl.batch(b, SEED + 100)
    _build.reset_launch_counts()
    mspec = tapi.QuerySpec(k=k, mode="multiprobe", n_probes=8, max_flips=3)
    probe, _ = _timed_query(index, q, w, tapi.QuerySpec(k=k))
    mp, _ = _timed_query(index, q, w, mspec)
    ms = _median_ms(index, q, w, mspec)
    _check_result(mp, b, k)
    ex = index.query(q[:64], w[:64], tapi.QuerySpec(k=k, mode="exact"))
    rec, rec_probe = recall_at_k(mp.ids[:64], ex.ids, k), recall_at_k(probe.ids[:64], ex.ids, k)
    cand_frac = float(mp.n_candidates.float().mean()) / index.n
    worse = int((mp.dists > probe.dists + 1e-6).sum())
    print(f"  [theta multiprobe] {b} queries in {ms:.2f} ms (median of 5 warm; "
          f"{ms / b * 1e3:.2f} us/query) "
          f"cand_frac={cand_frac:.5f} (probe "
          f"{float(probe.n_candidates.float().mean()) / index.n:.5f}) recall@{k}={rec:.3f} "
          f"(probe {rec_probe:.3f}); slots where multiprobe is worse than probe: {worse}")
    if worse or not bool((mp.n_candidates >= probe.n_candidates).all()):
        raise AssertionError("multiprobe must see a superset of the probe batch's candidates")
    profile("of one theta multiprobe batch", lambda: index.query(q, w, mspec), top=6)
    counts = _path_counts("multiprobe", ("alsh_project", "gather_rerank_topk"))
    return counts, {"ms": ms, "cand_frac": cand_frac, "recall": rec, "recall_probe": rec_probe}


def _no_dead_ids(label, res, tombstones):
    """Fails when a result holds an id the tombstones mark deleted."""
    ids = res.ids[res.ids >= 0].long()
    if bool(tombstones[ids].any()):
        raise AssertionError(f"{label}: a deleted id reached a result")


def phase_stream_path(svc):
    """The mutable index on the card in the order of ``serve --mode
    stream``: insert, FIFO retire, query the batch, exact spot-check,
    compact at the threshold; then int8 beside f32 for two ticks."""
    import dataclasses

    import torch

    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    wl, cfg = svc.wl, svc.index.config
    k, b, d = SERVICE.topk, SERVICE.query_batch, cfg.d
    spec = tapi.QuerySpec(k=k)
    exact = tapi.QuerySpec(k=k, mode="exact")
    update = tapi.UpdateSpec(delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD)
    sealed = svc.index.query(svc.q, svc.w, spec)  # before the counters are zeroed
    _build.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = tapi.Index.build(SEED + 2, wl.data, cfg, update=update)
    torch.cuda.synchronize()
    print(f"  [stream] built the mutable f32 index n={index.n} delta_capacity={STREAM_CAP} in "
          f"{time.perf_counter() - t0:.3f} s; table_bytes {index.table_bytes}")
    empty = index.query(svc.q, svc.w, spec)
    same = all(torch.equal(getattr(empty, f), getattr(sealed, f))
               for f in ("ids", "dists", "n_candidates"))
    print(f"  [stream] empty delta: answers equal the sealed index's bit for bit: {same}")
    if not same:
        raise AssertionError("a mutable index with an empty delta must answer as the sealed one")

    ticks, next_retire = [], 0
    for t in range(1, STREAM_TICKS + 1):
        centres, rows = stream_rows(SEED + 1000 + t, STREAM_INGEST // CLUSTER, d)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index, ids = index.insert(rows)
        torch.cuda.synchronize()
        ins_ms = (time.perf_counter() - t0) * 1e3
        retire = torch.arange(next_retire, next_retire + STREAM_RETIRE, dtype=torch.int32,
                              device="cuda")
        next_retire += STREAM_RETIRE
        t0 = time.perf_counter()
        index = index.delete(retire)
        torch.cuda.synchronize()
        del_ms = (time.perf_counter() - t0) * 1e3
        q, w = stream_batch(wl, centres, SEED + 2000 + t)
        res, ms = _timed_query(index, q, w, spec)
        ex, ex_ms = _timed_query(index, q[:64], w[:64], exact)
        _check_result(res, b, k)
        _check_result(ex, 64, k)
        for label, r in (("batch", res), ("exact check", ex)):
            _no_dead_ids(f"tick {t} {label}", r, index.tombstones)
        if not bool((ids >= index.n).all()):
            raise AssertionError(f"tick {t}: an insert was refused below the capacity")
        rec = recall_at_k(res.ids[:64], ex.ids, k)
        hit = float((res.ids[:STREAM_ON_NEW] >= index.n).any(dim=1).float().mean())
        print(f"  [stream] tick {t}: +{STREAM_INGEST} rows in {ins_ms:.2f} ms "
              f"({STREAM_INGEST / ins_ms * 1e3:,.0f} rows/s), -{STREAM_RETIRE} in {del_ms:.2f} ms, "
              f"{b} queries in {ms:.2f} ms ({ms / b * 1e3:.2f} us/query), exact check of 64 in "
              f"{ex_ms:.2f} ms, delta={index.delta_fill}/{STREAM_CAP}, cand_frac="
              f"{float(res.n_candidates.float().mean()) / index.n:.5f}, recall@{k}={rec:.3f}, "
              f"delta hits {hit:.3f} of the {STREAM_ON_NEW} queries on new centres")
        if rec < THETA_RECALL_FLOOR:
            raise AssertionError(f"tick {t}: recall@{k} {rec:.3f} under {THETA_RECALL_FLOOR}")
        if hit < STREAM_HIT_FLOOR:
            raise AssertionError(f"tick {t}: only {hit:.3f} of the queries on new centres "
                                 f"found a delta row (floor {STREAM_HIT_FLOOR})")
        row = {"insert_ms": ins_ms, "delete_ms": del_ms, "batch_ms": ms, "exact_ms": ex_ms,
               "fill": index.delta_fill, "recall": rec, "delta_hits": hit}
        if index.needs_compact != (t == 12):
            raise AssertionError(f"tick {t}: needs_compact is {index.needs_compact} at fill "
                                 f"{index.delta_fill}")
        if index.needs_compact:
            profile(f"of one stream batch (tick {t}, fill {index.delta_fill})",
                    lambda: index.query(q, w, spec), unprofiled_wall=True)
            live = torch.from_numpy(index.live_ids()).to("cuda")
            survivors = torch.cat([index.state.data, index.delta.data])[live]  # f32: raw rows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compacted = index.compact()
            torch.cuda.synchronize()
            row["compact_ms"] = (time.perf_counter() - t0) * 1e3
            fresh = tapi.Index.build(SEED + 2, survivors, cfg, update=update)
            same_state = all(torch.equal(getattr(compacted.state, f), getattr(fresh.state, f))
                             for f in ("sorted_keys", "perm", "data", "levels"))
            a, f_ = compacted.query(q, w, spec), fresh.query(q, w, spec)
            same_ans = all(torch.equal(getattr(a, f), getattr(f_, f))
                           for f in ("ids", "dists", "n_candidates"))
            print(f"  [stream] compacted to n={compacted.n} in {row['compact_ms']:.2f} ms; "
                  f"sorted_keys/perm/data/levels equal Index.build over the survivors: "
                  f"{same_state}; answers equal: {same_ans}")
            if not (same_state and same_ans):
                raise AssertionError("compact() differs from a fresh build over the survivors")
            index, next_retire = compacted, 0
        ticks.append(row)

    # int8 beside f32, two ticks of the same operations
    twin = {s: tapi.Index.build(SEED + 2, wl.data, dataclasses.replace(cfg, storage=s),
                                update=update) for s in ("f32", "int8")}
    quant_rows = []
    for t in range(1, 3):
        centres, rows = stream_rows(SEED + 3000 + t, STREAM_INGEST // CLUSTER, d)
        retire = torch.arange((t - 1) * STREAM_RETIRE, t * STREAM_RETIRE, dtype=torch.int32,
                              device="cuda")
        for s_ in twin:
            twin[s_] = twin[s_].insert(rows)[0].delete(retire)
        q, w = stream_batch(wl, centres, SEED + 4000 + t)
        ref32 = twin["f32"].query(q, w, spec)
        own = twin["int8"].query(q[:64], w[:64], exact)
        for alpha in (SCREEN_ALPHA, 0.0):
            qspec = tapi.QuerySpec(k=k, screen_alpha=alpha)
            before = _build.launch_counts()["gather_rerank_topk_blocked_two_seg"]
            res, ms = _timed_query(twin["int8"], q, w, qspec)
            launched = _build.launch_counts()["gather_rerank_topk_blocked_two_seg"] - before
            _check_result(res, b, k)
            _no_dead_ids(f"int8 tick {t} alpha={alpha}", res, twin["int8"].tombstones)
            same_cand = torch.equal(res.n_candidates, ref32.n_candidates)
            rec = recall_at_k(res.ids[:64], own.ids, k)
            print(f"  [stream int8] tick {t} alpha={alpha}: {b} queries in {ms:.2f} ms "
                  f"({ms / b * 1e3:.2f} us/query), n_candidates equal to f32's: {same_cand}, "
                  f"recall@{k} vs own exact {rec:.3f}, quantized two-segment launches {launched}")
            if not same_cand:
                raise AssertionError("int8 mutable index: n_candidates differ from f32's")
            if launched != (2 if alpha else 1):
                raise AssertionError(f"int8 alpha={alpha}: {launched} launches of the quantized "
                                     f"two-segment kernel, expected {2 if alpha else 1}")
            if rec < QUANT_RECALL_FLOOR:
                raise AssertionError(f"int8 alpha={alpha}: recall@{k} {rec:.3f} under its floor")
            quant_rows.append({"tick": t, "alpha": alpha, "ms": ms, "recall_own": rec})
    counts = _path_counts("stream", ("alsh_project", "gather_rerank_topk_two_seg",
                                     "gather_rerank_topk_blocked_two_seg"))
    return counts, {"ticks": ticks, "int8": quant_rows}


def phase_unfused_path():
    """The unfused baseline of benchmarks/kernels_bench.py, which the fused
    kernels are measured against, on the card: the materializing scan then
    ``torch.topk`` against ``wl1_scan_topk`` (n=65,536, b=64, k=10, normal
    data, queries and weights), and ``data[ids]`` then ``wl1_rerank`` then
    ``torch.topk`` against ``gather_rerank_topk`` on real probe candidates
    (b=64, d=128, k=10, P=512…4096: uniform rows, queries at 0.01 from a row,
    weights |N(0,1)| + 0.1, an L=8, C=P/8, K=14, M=16 theta index). The two
    sides must agree: dists bit for bit (each kernel pair sums a row in one
    order), ids equal up to genuine ties. The indexing and ``torch.topk``
    are the baseline's plain XLA stages, not ports of a kernel."""
    import torch

    import repro_torch.api as tapi
    from repro_torch.core.index import _dedupe_candidates
    from repro_torch.engine.pipeline import probe_keys, sources_for
    from repro_torch.kernels import _build, ops

    n, b, d, k = BASELINE_N, BASELINE_B, 128, BASELINE_K
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    _build.reset_launch_counts()
    data, q, w = (torch.randn(s, generator=gen, device="cuda") for s in ((n, d), (b, d), (b, d)))

    def unfused_scan():
        vals, sel = torch.topk(ops.wl1_scan(data, q, w), k, dim=1, largest=False)
        return vals, sel.to(torch.int32)

    label = "scan: wl1_scan + torch.topk vs wl1_scan_topk"
    unfused, fused = unfused_scan(), ops.wl1_scan_topk(data, q, w, k)
    err = _check_topk(label, unfused, fused, data, q, w)
    _same_dists(label, unfused[0], fused[0])
    un_ms = time_ms(unfused_scan, iters=10, warmup=2)
    f_ms = time_ms(lambda: ops.wl1_scan_topk(data, q, w, k), iters=10, warmup=2)
    print(f"  scan n={n} b={b} k={k}: unfused {un_ms:.4f} ms, fused wl1_scan_topk {f_ms:.4f} ms "
          f"(unfused / fused {un_ms / f_ms:.2f})")
    rows = {"scan": {"unfused_ms": un_ms, "fused_ms": f_ms, "max_abs_err": err}}

    data = torch.rand((n, d), generator=gen, device="cuda")
    base = torch.randint(0, n, (b,), generator=gen, device="cuda")
    q = (data[base] + 0.01 * torch.randn((b, d), generator=gen, device="cuda")).clamp(0, 1)
    w = torch.randn((b, d), generator=gen, device="cuda").abs() + 0.1
    for P in BASELINE_P:
        cfg = tapi.IndexConfig(d=d, M=16, K=14, L=8, max_candidates=P // 8,
                               space=tapi.BoundedSpace(0.0, 1.0, 16.0))
        state = tapi.Index.build(SEED + P, data, cfg).state
        cand = sources_for(state, None, None, cfg, probe_keys(state, q, w, cfg))[0].emit(q, w)
        ids, n_cand = _dedupe_candidates(cand, n)

        def unfused_tail():
            pts = data[ids.clamp(max=n - 1).long()]  # the (b, P, d) gather
            dists = ops.wl1_rerank(pts, q, w)
            dists = torch.where(ids < n, dists, torch.full_like(dists, float("inf")))
            vals, sel = torch.topk(dists, k, dim=1, largest=False)
            out_i = torch.gather(ids, 1, sel)
            return vals, torch.where(torch.isfinite(vals), out_i, torch.full_like(out_i, -1))

        label = f"tail P={P}: data[ids] + wl1_rerank + torch.topk vs gather_rerank_topk"
        unfused, fused = unfused_tail(), ops.gather_rerank_topk(data, ids, q, w, k)
        err = _check_topk(label, unfused, fused, data, q, w)
        _same_dists(label, unfused[0], fused[0])
        un_ms = time_ms(unfused_tail, iters=10, warmup=2)
        f_ms = time_ms(lambda: ops.gather_rerank_topk(data, ids, q, w, k), iters=10, warmup=2)
        uniq = float(n_cand.float().mean())
        print(f"  tail P={P} ({uniq:.0f} unique ids per query): unfused {un_ms:.4f} ms, fused "
              f"gather_rerank_topk {f_ms:.4f} ms (unfused / fused {un_ms / f_ms:.2f})")
        rows[f"tail_P{P}"] = {"unfused_ms": un_ms, "fused_ms": f_ms, "unique_ids": uniq,
                              "max_abs_err": err}
    counts = _path_counts("unfused baseline", ("wl1_scan", "wl1_rerank"))
    return counts, rows


def _same_dists(label, unfused, fused):
    """The unfused side's distances must be the fused kernel's bit for bit:
    both sum each row in the same order (the scan's loop; the gathers' VEC4
    row body)."""
    import torch

    same = torch.equal(unfused, fused)
    print(f"  {label}: dists bit-equal: {same}")
    if not same:
        raise AssertionError(f"{label}: dists differ from the fused kernel's")


def phase_early_exit_path(svc):
    """The streamed early-exit query at the SERVICE width (serve's
    --exit-group 8): at slack 0 it must equal the monolithic query on the
    same batch — sealed f32, a mutable index after one stream tick, and int8
    storage with the screen off: dists bit for bit, ids up to genuine ties,
    equal n_candidates, every query exhausted after L·P windows. At slack
    0.1 (serve's default), probe and multiprobe (8 probes, up to 3 flips:
    256 windows in 32 groups) on the f32 index: batch ms beside the
    monolithic batch's, tables_probed (mean, p99), the stop-reason mix, the
    groups run, recall@10 against exact mode beside the monolithic recall,
    held to the theta floor. Then ``Index.explain`` and ``serve --mode alsh
    --early-exit --stats`` once each."""
    import contextlib
    import dataclasses
    import io
    import math

    import torch

    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.core.families import n_flip_subsets
    from repro_torch.distance import recall_at_k
    from repro_torch.engine.stream import STOP_EXHAUSTED
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import unexplained_id_mismatches
    from repro_torch.launch import serve

    index, cfg = svc.index, svc.index.config
    k, b = SERVICE.topk, SERVICE.query_batch
    q, w = svc.wl.batch(b, SEED + 100)  # the f32 path's first batch
    mp = tapi.QuerySpec(k=k, mode="multiprobe", n_probes=8, max_flips=3)
    windows = {"probe": cfg.L, "multiprobe": cfg.L * min(8, n_flip_subsets(cfg.K, 3))}
    rows = {}
    _build.reset_launch_counts()

    def slack0(label, idx, qq, ww, off_spec):
        on_spec = dataclasses.replace(off_spec, early_exit=True, exit_group=EXIT_GROUP,
                                      exit_slack=0.0)
        on, on_ms = _timed_query(idx, qq, ww, on_spec)
        off, off_ms = _timed_query(idx, qq, ww, off_spec)
        _check_result(on, b, k)
        table = quant.decode_table(torch.cat([idx.state.data, idx.delta.data]), idx.state.scales)
        bits = torch.equal(on.dists, off.dists)
        ties = int((on.ids != off.ids).sum())
        bad = unexplained_id_mismatches(on.ids, off.dists, off.ids, table, qq, ww, DIST_RTOL,
                                        DIST_ATOL)
        cand = torch.equal(on.n_candidates, off.n_candidates)
        exhausted = bool((on.stop_reason == STOP_EXHAUSTED).all())
        full = bool((on.tables_probed == cfg.L).all())
        print(f"  [{label}] slack 0: streamed {on_ms:.2f} ms, monolithic {off_ms:.2f} ms (one "
              f"call each); dists bit-equal {bits}, id mismatches {ties} (not genuine ties "
              f"{bad}), n_candidates equal {cand}, all exhausted {exhausted}, "
              f"tables_probed == {cfg.L} for all {full}")
        if not (bits and bad == 0 and cand and exhausted and full):
            raise AssertionError(f"{label}: the streamed query at slack 0 differs from the "
                                 f"monolithic query")
        rows[f"{label}/slack0"] = {"ms": on_ms, "monolithic_ms": off_ms}

    slack0("f32 probe", index, q, w, tapi.QuerySpec(k=k))
    update = tapi.UpdateSpec(delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD)
    mut = tapi.Index.build(SEED + 2, svc.wl.data, cfg, update=update)
    centres, new_rows = stream_rows(SEED + 5000, STREAM_INGEST // CLUSTER, cfg.d)
    mut = mut.insert(new_rows)[0].delete(torch.arange(0, STREAM_RETIRE, dtype=torch.int32,
                                                      device="cuda"))
    qs, ws = stream_batch(svc.wl, centres, SEED + 5001)
    slack0(f"f32 mutable, delta fill {mut.delta_fill}", mut, qs, ws, tapi.QuerySpec(k=k))
    del mut
    int8 = tapi.Index.build(SEED + 2, svc.wl.data, dataclasses.replace(cfg, storage="int8"))
    slack0("int8, screen off", int8, q, w, tapi.QuerySpec(k=k))
    del int8

    ex = index.query(q[:64], w[:64], tapi.QuerySpec(k=k, mode="exact"))
    names = {0: "exhausted", 1: "geometric", 2: "confidence"}
    for label, base in (("probe", tapi.QuerySpec(k=k)), ("multiprobe", mp)):
        spec = dataclasses.replace(base, early_exit=True, exit_group=EXIT_GROUP,
                                   exit_slack=EXIT_SLACK)
        res, _ = _timed_query(index, q, w, spec)
        mono, _ = _timed_query(index, q, w, base)
        ms, mono_ms = _median_ms(index, q, w, spec), _median_ms(index, q, w, base)
        _check_result(res, b, k)
        tp = res.tables_probed.float()
        n_win = windows[label]
        groups_run = math.ceil(float(tp.max()) / EXIT_GROUP)
        mix = {names[c]: int((res.stop_reason == c).sum()) for c in names}
        rec, rec_mono = recall_at_k(res.ids[:64], ex.ids, k), recall_at_k(mono.ids[:64], ex.ids, k)
        print(f"  [{label}] slack {EXIT_SLACK}: {b} queries in {ms:.2f} ms (median of 5 warm), "
              f"monolithic {mono_ms:.2f} ms; tables_probed mean {float(tp.mean()):.2f} p99 "
              f"{float(torch.quantile(tp, 0.99)):.1f} of {n_win}; groups run {groups_run} of "
              f"{math.ceil(n_win / EXIT_GROUP)}; stop reasons {mix}; recall@{k} {rec:.3f} "
              f"(monolithic {rec_mono:.3f}); cand_frac "
              f"{float(res.n_candidates.float().mean()) / index.n:.5f} (monolithic "
              f"{float(mono.n_candidates.float().mean()) / index.n:.5f})")
        if rec < THETA_RECALL_FLOOR:
            raise AssertionError(f"early exit {label}: recall@{k} {rec:.3f} is under its floor "
                                 f"{THETA_RECALL_FLOOR}")
        if not (bool((tp >= 1).all()) and bool((tp <= n_win).all())):
            raise AssertionError(f"early exit {label}: tables_probed outside [1, {n_win}]")
        profile(f"of one streamed {label} batch (slack {EXIT_SLACK})",
                lambda: index.query(q, w, spec), top=6, unprofiled_wall=True)
        rows[f"{label}/slack{EXIT_SLACK}"] = {
            "ms": ms, "monolithic_ms": mono_ms, "tables_probed_mean": float(tp.mean()),
            "tables_probed_p99": float(torch.quantile(tp, 0.99)), "groups_run": groups_run,
            "stop_reasons": mix, "recall": rec, "recall_monolithic": rec_mono}

    spec = tapi.QuerySpec(k=k, early_exit=True, exit_group=EXIT_GROUP, exit_slack=EXIT_SLACK)
    rep = index.explain(q[:64], w[:64], spec)
    ok = (rep.tables_probed is not None and rep.stop_reason is not None
          and bool(((rep.tables_probed >= 1) & (rep.tables_probed <= cfg.L)).all())
          and set(rep.stop_reason.tolist()) <= {0, 1, 2})
    print(f"  Index.explain: {json.dumps(rep.to_dict())}")
    if not ok:
        raise AssertionError("Index.explain: tables_probed / stop_reason missing or out of range")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(["--mode", "alsh", "--n", str(SERVICE.n_per_shard), "--d", str(SERVICE.d),
                    "--query-batch", str(b), "--batches", "1", "--early-exit", "--stats"])
    out = buf.getvalue()
    print("\n".join(f"  {line}" for line in out.splitlines()))
    stats = [line for line in out.splitlines() if "stats: tables_probed~" in line]
    if len(stats) != 1:
        raise AssertionError("serve --early-exit --stats printed no tables_probed line")
    mean_tp, n_win = stats[0].split("tables_probed~")[1].split()[0].split("/")
    if not 1.0 <= float(mean_tp) <= float(n_win):
        raise AssertionError(f"serve --stats: tables_probed {mean_tp} outside [1, {n_win}]")
    counts = _path_counts("early exit", ("alsh_project", "gather_rerank_topk",
                                         "gather_rerank_topk_two_seg",
                                         "gather_rerank_topk_blocked", "wl1_scan_topk"))
    return counts, rows


def _launched(fn):
    """``fn()`` and the kernel launches it made."""
    from repro_torch.kernels import _build

    before = _build.launch_counts()
    out = fn()
    after = _build.launch_counts()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _same_answer(label, a, b, launches_a, launches_b):
    import torch

    same = all(torch.equal(getattr(a, f), getattr(b, f)) for f in ("ids", "dists", "n_candidates"))
    print(f"  [persist] {label}: ids, dists and n_candidates bit-equal to the saved index's: "
          f"{same}; launches {launches_b} (saved index: {launches_a})")
    if not same:
        raise AssertionError(f"{label}: the loaded index answers differently from the saved one")
    if launches_a != launches_b:
        raise AssertionError(f"{label}: the loaded index launched {launches_b}, the saved one "
                             f"{launches_a}")


def _same_state(label, a, b):
    """Every tensor of two indexes equal by bits (``tiled`` too)."""
    import torch

    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t

    pairs = [(f"state.{f}", getattr(a.state, f), getattr(b.state, f))
             for f in ("mixers", "sorted_keys", "perm", "data", "levels", "scales")]
    pairs += [(f"tables.{f}", getattr(a.state.tables, f), getattr(b.state.tables, f))
              for f in ("folded", "offsets", "tiled")]
    pairs += [(f"delta.{f}", getattr(a.delta, f), getattr(b.delta, f))
              for f in ("data", "levels", "keys")]
    pairs.append(("tombstones", a.tombstones, b.tombstones))
    bad = [name for name, x, y in pairs
           if (x is None) != (y is None) or (x is not None and not torch.equal(bits(x), bits(y)))]
    if a.delta_fill != b.delta_fill:
        bad.append("delta.fill")
    print(f"  [persist] {label}: {len(pairs) + 1} leaves compared, unequal: {bad or 'none'}")
    if bad:
        raise AssertionError(f"{label}: loaded leaves differ: {bad}")


def _round_trip(label, index, directory, card):
    """Save ``index`` into ``directory`` and load it back with the default
    device; prints the times (host clock; the load includes the copy to the
    card), the bytes on disk and the codec, beside the card's name."""
    import os

    import torch

    import repro_torch.api as tapi

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.save(directory)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = tapi.Index.load(directory)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    files = [os.path.join(r, f) for r, _, fs in os.walk(directory) for f in fs]
    on_disk = sum(os.path.getsize(f) for f in files)
    codec = "zstd" if any(f.endswith(".msgpack.zst") for f in files) else "zlib"
    raw = sum(t.nbytes for t in (index.state.tables.folded, index.state.tables.offsets,
                                 index.state.mixers, index.state.sorted_keys, index.state.perm,
                                 index.state.data, index.state.levels, index.delta.data,
                                 index.delta.levels, index.delta.keys, index.tombstones))
    print(f"  [persist] {label}: save {save_s:.3f} s, load {load_s:.3f} s (host clock, the load "
          f"with its copy to {loaded.device}); {raw} B of leaves, {on_disk} B on disk "
          f"({codec}, {on_disk / raw:.3f} of raw); {card}")
    if loaded.device.type != "cuda":
        raise AssertionError(f"{label}: Index.load put the index on {loaded.device}")
    return loaded, {"save_s": save_s, "load_s": load_s, "raw_bytes": raw,
                    "disk_bytes": on_disk, "codec": codec}


def phase_persist_path(svc, card):
    """Persistence at the SERVICE width, through ``Index.save`` and
    ``Index.load`` with the default device: the f32 sealed service index
    (every leaf and ``tiled`` equal; the probe batch and 64 exact queries
    bit-equal, with equal launch counts); int8 and f32 mutable indexes after
    two stream ticks (fill 1024, 256 tombstones; the two-segment queries
    bit-equal, and again after one more tick and after a compact on both);
    a bf16 sealed index (leaves equal by bits); then, on n=8192, a flipped
    payload byte raises ``CorruptCheckpointError`` and a removed ``COMMIT``
    ``FileNotFoundError``. The indexes to be saved are built, and the
    mutable ones take their first two ticks, before the launch counts are
    zeroed: the path's counts are those of the saves, the loads, the queries
    of both copies and the tick and compact after the load. Prints the save
    and load seconds and the bytes on disk beside ``card``, which of
    msgpack, zstandard and ml_dtypes this machine has, and that the saves
    and loads imported neither msgpack nor ml_dtypes."""
    import dataclasses
    import glob
    import importlib.util
    import os
    import tempfile

    import torch

    import repro_torch.api as tapi
    from repro_torch.ckpt import CorruptCheckpointError
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import _build

    installed = {m: importlib.util.find_spec(m) is not None
                 for m in ("msgpack", "zstandard", "ml_dtypes")}
    print(f"  [persist] installed on this machine: {installed}")
    modules_before = set(sys.modules)
    wl, cfg = svc.wl, svc.index.config
    k, b, d = SERVICE.topk, SERVICE.query_batch, cfg.d
    spec, exact = tapi.QuerySpec(k=k), tapi.QuerySpec(k=k, mode="exact")
    rows = {}
    update = tapi.UpdateSpec(delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD)

    def tick(idx, t):
        _, new = stream_rows(SEED + 5000 + t, STREAM_INGEST // CLUSTER, d)
        retire = torch.arange((t - 1) * STREAM_RETIRE, t * STREAM_RETIRE, dtype=torch.int32,
                              device="cuda")
        return idx.insert(new)[0].delete(retire)

    # set-up, off the path's counts: the indexes to be saved
    mutable = {}
    for storage in ("int8", "f32"):
        idx = tapi.Index.build(SEED + 2, wl.data, dataclasses.replace(cfg, storage=storage),
                               update=update)
        for t in (1, 2):
            idx = tick(idx, t)
        mutable[storage] = idx
    bf16 = tapi.Index.build(SEED + 2, wl.data, dataclasses.replace(cfg, storage="bf16"))
    small = tapi.Index.build(SEED, Workload(8192, d, seed=SEED + 7).data, cfg)
    del idx
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_persist_") as tmp:
        # 1. the f32 sealed service index
        loaded, rows["f32"] = _round_trip("f32 sealed", svc.index, os.path.join(tmp, "f32"),
                                          card)
        _same_state("f32 sealed", svc.index, loaded)
        for label, qq, ww, s in (("f32 probe batch", svc.q, svc.w, spec),
                                 ("f32 exact, 64 queries", svc.q[:64], svc.w[:64], exact)):
            a, la = _launched(lambda: svc.index.query(qq, ww, s))
            c, lc = _launched(lambda: loaded.query(qq, ww, s))
            _check_result(c, qq.shape[0], k)
            _same_answer(label, a, c, la, lc)
        del loaded

        # 2. int8 and f32 mutable indexes after two stream ticks
        for storage in ("int8", "f32"):
            idx = mutable.pop(storage)
            fill, dead = idx.delta_fill, int(idx.tombstones.sum())
            print(f"  [persist] {storage} mutable: delta fill {fill}, {dead} tombstones")
            if (fill, dead) != (2 * STREAM_INGEST, 2 * STREAM_RETIRE):
                raise AssertionError(f"{storage} mutable: fill {fill}, {dead} tombstones")
            label = f"{storage} mutable"
            back, rows[label] = _round_trip(label, idx, os.path.join(tmp, storage + "_mut"),
                                            card)
            _same_state(label, idx, back)
            q, w = stream_batch(wl, stream_rows(SEED + 5000 + 2, 32, d)[0], SEED + 5100)
            alphas = (SCREEN_ALPHA, 0.0) if storage == "int8" else (0.0,)
            for stage in ("loaded", "one more tick", "compacted"):
                if stage == "one more tick":
                    idx, back = tick(idx, 3), tick(back, 3)
                elif stage == "compacted":
                    idx, back = idx.compact(), back.compact()
                for alpha in alphas:
                    s = tapi.QuerySpec(k=k, screen_alpha=alpha)
                    a, la = _launched(lambda: idx.query(q, w, s))
                    c, lc = _launched(lambda: back.query(q, w, s))
                    _check_result(c, b, k)
                    _same_answer(f"{label}, {stage}, alpha={alpha}", a, c, la, lc)
            del idx, back

        # 3. the bf16 sealed index
        back, rows["bf16"] = _round_trip("bf16 sealed", bf16, os.path.join(tmp, "bf16"), card)
        _same_state("bf16 sealed", bf16, back)
        a, la = _launched(lambda: bf16.query(svc.q, svc.w, spec))
        c, lc = _launched(lambda: back.query(svc.q, svc.w, spec))
        _same_answer("bf16 probe batch", a, c, la, lc)
        del bf16, back

        # 4. named errors on a small index
        for damage, want in (("flipped payload byte", CorruptCheckpointError),
                             ("removed COMMIT", FileNotFoundError)):
            path = small.save(os.path.join(tmp, damage.replace(" ", "_")))
            if want is CorruptCheckpointError:
                (shard,) = glob.glob(os.path.join(path, "step_*", "shard_*"))
                blob = bytearray(open(shard, "rb").read())
                blob[len(blob) // 2] ^= 0xFF
                open(shard, "wb").write(bytes(blob))
            else:
                os.remove(glob.glob(os.path.join(path, "step_*", "COMMIT"))[0])
            try:
                tapi.Index.load(path)
            except want as e:
                print(f"  [persist] {damage}: {type(e).__name__}: {str(e)[:120]}")
            else:
                raise AssertionError(f"{damage}: Index.load did not raise {want.__name__}")
    imported = sorted({m.split(".")[0] for m in set(sys.modules) - modules_before}
                      & {"msgpack", "ml_dtypes", "jax", "repro"})
    print(f"  [persist] the saves and loads imported msgpack, ml_dtypes, jax or repro: "
          f"{imported or 'none'} (in this process at all: "
          f"{sorted(m for m in ('msgpack', 'ml_dtypes') if m in sys.modules) or 'none'})")
    if imported:
        raise AssertionError(f"persistence imported {imported}")
    counts = _path_counts("persist", ("alsh_project", "gather_rerank_topk",
                                      "gather_rerank_topk_two_seg", "gather_rerank_topk_blocked",
                                      "gather_rerank_topk_blocked_two_seg", "wl1_scan_topk"))
    return counts, rows


def _timed_planner(tapi, weights):
    """A ``Planner`` calibrating with ``weights`` that stamps when
    ``plan_config`` and each calibrated attempt start and end (host clock,
    after a device sync)."""
    import torch

    class TimedPlanner(tapi.Planner):
        def _mark(self, label):
            torch.cuda.synchronize()
            self.__dict__.setdefault("marks", []).append((label, time.perf_counter()))

        def plan_config(self, *args, **kwargs):
            self._mark("config start")
            cfg = super().plan_config(*args, **kwargs)
            self._mark("config end")
            return cfg

        def plan_query(self, index, quality):
            self._mark(f"calibration start K={index.config.K} L={index.config.L} "
                       f"C={index.config.max_candidates}")
            plan = super().plan_query(index, quality)
            self._mark("calibration end")
            return plan

    return TimedPlanner(weights=weights)


def _attempts(marks):
    """(geometry, build seconds, calibration seconds) per attempt from the
    planner's marks; each build runs from the end of the step before it."""
    out, prev_end = [], None
    for i, (label, t) in enumerate(marks):
        if label in ("config end", "calibration end"):
            prev_end = t
        elif label.startswith("calibration start"):
            out.append((label[len("calibration start "):], t - prev_end, marks[i + 1][1] - t))
    return out


def phase_plan_path(run, svc, card):
    """Quality-first planning and the offline tuner at the SERVICE width
    (n=262,144, d=128, batches of 1024), launch counts zeroed before its
    builds:

    1. ``Index.build(seed, data, QualitySpec(k=10, recall_target=0.9),
       family="theta", M=32)`` on the card with the default planner (its
       calibration weights |N(0,1)| + 0.1): its geometry, plan, seconds and
       held-out recall, or the planner's own refusal when the theory solve
       finds no usable collision probabilities (any other error fails);
       then the same build with a planner that calibrates on the service's
       own query weights (64 rows of 1 + 0.1·|N(0,1)|), which the rest of
       the path uses: the derived config, the attempts, the seconds of
       ``plan_config``, of each build and of each calibration, and
       ``plan_build_s``;
    2. ``query(q, w, quality)`` equals ``query(q, w, index.plan(quality))``
       bit for bit with equal launch counts on the service batch; its ms and
       device busy time beside the explicit SERVICE index's, and its
       recall@10 against exact mode on 64 held-out queries beside the
       plan's ``predicted_recall``;
    3. ``plan_ladder``: rung 0 is the plan and the costs strictly fall;
       ``explain`` reports "calibrated", ``plan_build_s``, the query's answer;
    4. the int8 SERVICE index plans (its screened rungs run the blocked
       gather): the chosen rung and its ``screen_alpha``;
    5. save and ``Index.load`` onto the card: the plans are equal, and a
       quality query launches no ``wl1_scan_topk`` (no calibration ran);
    6. the tuner over the SERVICE geometry (theta, K=12, L=32, probes 1, 2,
       4, 8, windows 64, 128) on a profile of the service's own rows
       (``source="sampled"``, weight skew ``PLAN_SKEW``), inline and with
       2 spawned workers (equal deterministic fields, equal launch counts:
       the workers' launches are added to this process's), its table, and
       ``Planner(table=...)`` on the SERVICE index at the path's target
       0.9: a prior plan's confirmation recall and its recall on the
       held-out queries meet the target less ``confirm_slack``, a
       calibrated one equals the table-less plan; the confirmation's
       seconds beside the full calibration's;
    7. the candidates per ms the card re-ranks on the f32 probe batch beside
       the planner's ``candidates_per_ms`` default (unchanged: both packages
       must choose alike)."""
    import dataclasses
    import os
    import tempfile
    import warnings

    import torch

    import repro_torch.api as tapi
    from repro_torch import tuner
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    wl, q, w = svc.wl, svc.q, svc.w
    k, b = SERVICE.topk, SERVICE.query_batch
    quality = tapi.QualitySpec(k=PLAN_K, recall_target=PLAN_RECALL)
    rows = {"card": card}
    weights = wl.batch(64, SEED + 9000)[1]  # the service's query-weight distribution
    hq, hw = wl.batch(PLAN_HELD_OUT, SEED + 9100)
    exact = tapi.QuerySpec(k=k, mode="exact")
    _build.reset_launch_counts()

    # 1. the quality build: the default planner, then the workload's weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            default = tapi.Index.build(SEED + 2, wl.data, quality, family="theta", M=32)
    except ValueError as e:
        if "no hash family yields usable" not in str(e):
            raise
        print(f"  [plan] default planner (weights |N(0,1)|+0.1): the theory solve refused "
              f"after {time.perf_counter() - t0:.3f} s: {str(e)[:110]}")
        rows.update(default_planner="refused: no usable collision probabilities")
    else:
        torch.cuda.synchronize()
        dplan = default.plans[quality]
        dheld = recall_at_k(default.query(hq, hw, dplan).ids, default.query(hq, hw, exact).ids, k)
        print(f"  [plan] default planner (weights |N(0,1)|+0.1): {time.perf_counter() - t0:.3f} s; "
              f"K={default.config.K} L={default.config.L} C={default.config.max_candidates}; "
              f"{dplan.mode} probes {dplan.n_probes} window {dplan.max_candidates} early_exit "
              f"{dplan.early_exit}, predicted_recall {dplan.predicted_recall:.4f}, held-out "
              f"recall@{k} {dheld:.4f}; plan_build_s {default.plan_times[quality]:.3f} s; "
              f"warnings: {[str(x.message)[:100] for x in caught] or 'none'}")
        if default.device.type != "cuda":
            raise AssertionError(f"the default quality build ran on {default.device}")
        rows.update(default_planner=str(dplan), default_config=str(default.config),
                    default_held_out_recall=dheld, default_plan_build_s=default.plan_times[quality])
        del default
    planner = _timed_planner(tapi, weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        index = tapi.Index.build(SEED + 2, wl.data, quality, family="theta", M=32,
                                 planner=planner)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, plan = index.config, index.plans[quality]
    marks = planner.marks
    config_s = marks[1][1] - marks[0][1]
    attempts = _attempts(marks)
    print(f"  [plan] Index.build(QualitySpec(k={PLAN_K}, recall_target={PLAN_RECALL})) on "
          f"{index.device}: {build_s:.3f} s in all; plan_config {config_s:.3f} s -> {cfg}")
    for i, (geom, bs, cs) in enumerate(attempts):
        print(f"  [plan]   attempt {i + 1}: {geom}: build {bs:.3f} s, calibration {cs:.3f} s")
    print(f"  [plan] plan: {plan}; plan_build_s {index.plan_times[quality]:.3f} s; "
          f"warnings: {[str(x.message)[:100] for x in caught] or 'none'}")
    if index.device.type != "cuda":
        raise AssertionError(f"the quality build ran on {index.device}")
    # where the calibration's time goes: each rung once more on its sample
    qs, ws, _ = planner._calibration_sample(index, quality)
    per_rung = [(r, _timed_query(index, qs, ws, r)[1])
                for r in planner._plan_ladder(cfg, quality.k, exit_slack=quality.fail_prob)]
    streamed = [ms for r, ms in per_rung if r.early_exit]
    mono = [ms for r, ms in per_rung if not r.early_exit]
    print(f"  [plan] calibration rungs on {qs.shape[0]} queries: {len(mono)} monolithic "
          f"{sum(mono):.1f} ms, {len(streamed)} streamed (early exit) {sum(streamed):.1f} ms; "
          + ", ".join(f"{r.mode[0]}{r.n_probes}/{r.max_candidates}{'/ee' if r.early_exit else ''}"
                      f" {ms:.1f}" for r, ms in per_rung))
    rows.update(rungs_monolithic_ms=sum(mono), rungs_streamed_ms=sum(streamed))
    rows.update(build_s=build_s, plan_config_s=config_s, attempts=[
        {"geometry": g, "build_s": bs, "calibration_s": cs} for g, bs, cs in attempts],
        plan_build_s=index.plan_times[quality], config=str(cfg), plan=str(plan))

    # 2. the planned answer
    a, la = _launched(lambda: index.query(q, w, quality))
    c, lc = _launched(lambda: index.query(q, w, index.plan(quality)))
    same = all(torch.equal(getattr(a, f), getattr(c, f)) for f in ("ids", "dists",
                                                                 "n_candidates"))
    print(f"  [plan] query(quality) vs query(plan): bit-equal {same}; launches {la} / {lc}")
    if not same or la != lc:
        raise AssertionError("query(q, w, quality) differs from query(q, w, index.plan(quality))")
    _check_result(a, b, k)
    explicit = tapi.QuerySpec(k=k)
    ms_plan = _median_ms(index, q, w, plan)
    ms_service = _median_ms(svc.index, q, w, explicit)
    busy_plan = profile("of one planned batch", lambda: index.query(q, w, plan), top=6)
    busy_service = profile("of one explicit SERVICE batch",
                           lambda: svc.index.query(q, w, explicit), top=6)
    held = recall_at_k(index.query(hq, hw, plan).ids, index.query(hq, hw, exact).ids, k)
    held_service = recall_at_k(svc.index.query(hq, hw, explicit).ids,
                               svc.index.query(hq, hw, exact).ids, k)
    print(f"  [plan] batch of {b}: planned {ms_plan:.3f} ms (device busy {_fmt_us(busy_plan)}), "
          f"explicit SERVICE {ms_service:.3f} ms (device busy {_fmt_us(busy_service)}); held-out "
          f"recall@{k} on {PLAN_HELD_OUT} queries {held:.4f} (predicted_recall "
          f"{plan.predicted_recall:.4f}; SERVICE {held_service:.4f}); {card}")
    rows.update(ms=ms_plan, ms_service=ms_service, busy_us=busy_plan,
                busy_us_service=busy_service, held_out_recall=held,
                held_out_recall_service=held_service, predicted_recall=plan.predicted_recall)

    # 3. the ladder and explain
    t0 = time.perf_counter()
    ladder = index.plan_ladder(quality, planner=planner)
    ladder_s = time.perf_counter() - t0
    costs = [planner._plan_cost(cfg, r, r.expected_candidates) for r in ladder]
    print(f"  [plan] plan_ladder: {len(ladder)} rungs in {ladder_s:.3f} s, costs "
          f"{[round(x, 1) for x in costs]}, recalls "
          f"{[round(r.predicted_recall, 3) for r in ladder]}")
    if ladder[0] != index.plan(quality):
        raise AssertionError("plan_ladder rung 0 is not index.plan(quality)")
    if not all(x > y for x, y in zip(costs, costs[1:])):
        raise AssertionError(f"ladder costs do not strictly fall: {costs}")
    rep = index.explain(q, w, quality)
    if rep.provenance != "calibrated" or rep.plan_build_s is None:
        raise AssertionError(f"explain: provenance {rep.provenance}, plan_build_s "
                             f"{rep.plan_build_s}")
    if not (torch.equal(rep.result.ids, a.ids) and torch.equal(rep.result.dists, a.dists)):
        raise AssertionError("explain changed the answer")
    print(f"  [plan] explain: provenance {rep.provenance}, plan_build_s {rep.plan_build_s:.3f} s,"
          f" mean predicted success {float(rep.predicted_success.mean()):.4f}, truncated "
          f"windows in {int((rep.truncated_tables > 0).sum())}/{b} queries")
    rows.update(ladder_rungs=len(ladder), ladder_s=ladder_s)

    # 4. a quantized index plans: its screened rungs run the blocked gather
    int8 = tapi.Index.build(SEED + 2, wl.data,
                            dataclasses.replace(SERVICE.index_config, storage="int8"))
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (p8, l8) = _launched(lambda: int8.plan(quality, planner=tapi.Planner(weights=weights)))
    int8_s = time.perf_counter() - t0
    print(f"  [plan] int8 SERVICE index planned in {int8_s:.3f} s: {p8.mode}, window "
          f"{p8.max_candidates}, probes {p8.n_probes}, early_exit {p8.early_exit}, "
          f"screen_alpha {p8.screen_alpha}; predicted_recall {p8.predicted_recall:.4f}; "
          f"launches {l8}; warnings: {[str(x.message)[:100] for x in caught] or 'none'}")
    if not l8.get("gather_rerank_topk_blocked"):
        raise AssertionError("the int8 calibration never ran the blocked gather")
    rows.update(int8_plan=str(p8), int8_s=int8_s)
    del int8

    # 5. the plan memo persists
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
        loaded, _ = _round_trip("planned index", index, os.path.join(tmp, "planned"), card)
        if loaded.plans != index.plans:
            raise AssertionError(f"loaded plans {loaded.plans} != saved {index.plans}")
        c, lc = _launched(lambda: loaded.query(q, w, quality))
        if lc.get("wl1_scan_topk") or not torch.equal(c.ids, a.ids):
            raise AssertionError(f"the loaded index recalibrated or answered differently: {lc}")
        print(f"  [plan] loaded plans equal the saved ones; quality query on the loaded index: "
              f"launches {lc} (no wl1_scan_topk: no calibration), ids equal")
        del loaded

        # 6. the tuner over the SERVICE geometry, on the service's own rows
        space = tuner.ScanSpace(
            profiles=(tuner.DataProfile(n=SERVICE.n_per_shard, d=SERVICE.d, skew=PLAN_SKEW,
                                        source="sampled"),),
            families=("theta",), K=(SERVICE.K,), L=(SERVICE.L,), n_probes=(1, 2, 4, 8),
            window=(64, 128))
        real = wl.data.cpu().numpy()
        t0 = time.perf_counter()
        inline, inline_l = _launched(lambda: tuner.run_scan(
            space, os.path.join(tmp, "inline.jsonl"), real_data=real))
        inline_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        pooled, pooled_l = _launched(lambda: tuner.run_scan(
            space, os.path.join(tmp, "pooled.jsonl"), workers=TUNE_WORKERS, real_data=real))
        pooled_s = time.perf_counter() - t0
        del real
        fields = ("trial_id", "status", "recall", "cand_frac", "cost", "mem_bytes", "W",
                  "tables_probed")
        differ = [(r["trial_id"], f) for r, p in zip(inline, pooled) for f in fields
                  if r.get(f) != p.get(f)]
        for r in inline:
            print(f"  [plan]   trial {r['trial_id']}: probes {r['n_probes']} window "
                  f"{r['window']}: recall {r['recall']:.4f} cand_frac {r['cand_frac']:.5f} "
                  f"cost {r['cost']:.1f} {r['us_per_query']:.2f} us/query")
        print(f"  [plan] tuner: {len(inline)} trials inline in {inline_s:.3f} s (launches "
              f"{inline_l}), with {TUNE_WORKERS} spawned workers in {pooled_s:.3f} s (their "
              f"launches {pooled_l}); deterministic fields differing: {differ or 'none'}")
        if len(inline) != len(space.trials()) or len(pooled) != len(inline) or differ:
            raise AssertionError(f"the spawn scan differs from the inline one: {differ}")
        if pooled_l != inline_l or not inline_l.get("wl1_scan_topk"):
            raise AssertionError(f"the workers' launches {pooled_l} differ from the inline "
                                 f"scan's {inline_l}")
    table = tuner.build_table(inline, space)
    bucket = table.nearest_bucket("theta", svc.index.n, svc.index.config.d, PLAN_SKEW)
    best = max(e["recall"] for e in bucket["entries"])
    prior_planner = tapi.Planner(table=table, weights=weights, profile_skew=PLAN_SKEW)
    bare_planner = tapi.Planner(weights=weights)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (prior, prior_l) = _launched(lambda: prior_planner.plan_query(svc.index, quality))
        torch.cuda.synchronize()
        prior_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        bare = bare_planner.plan_query(svc.index, quality)
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
    prior_held = recall_at_k(svc.index.query(hq, hw, prior).ids,
                             svc.index.query(hq, hw, exact).ids, k)
    costs = [bare_planner._plan_cost(svc.index.config, p, p.expected_candidates)
             for p in (prior, bare)]
    print(f"  [plan] table: {len(table.buckets)} bucket(s), best frontier recall {best:.4f}; "
          f"Planner(table) on the SERVICE index at recall_target {quality.recall_target}: "
          f"{prior.provenance} in {prior_s:.3f} s (launches {prior_l}; {prior}; cost "
          f"{costs[0]:.1f}; held-out recall@{k} {prior_held:.4f}); full calibration "
          f"{bare_s:.3f} s ({bare}; cost {costs[1]:.1f})")
    if prior.provenance == "prior":
        bar = quality.recall_target - prior_planner.confirm_slack
        if prior.predicted_recall < bar or prior_held < bar:
            raise AssertionError(f"a prior plan under its bar {bar} was accepted: confirmation "
                                 f"{prior.predicted_recall}, held-out {prior_held}")
    elif prior != bare:
        raise AssertionError("a calibrated fallback differs from the table-less plan")
    rows.update(tune_inline_s=inline_s, tune_pooled_s=pooled_s, prior_provenance=prior.provenance,
                prior_s=prior_s, full_calibration_s=bare_s, prior_held_out_recall=prior_held,
                prior_cost=costs[0], full_calibration_cost=costs[1], tune_best_recall=best)

    # 7. candidates per ms on the f32 probe batch
    gather_ms = run.kernels.get("gather_rerank_topk", {}).get("ms")
    per_ms = svc.valid / ms_service
    print(f"  [plan] the f32 probe batch re-ranks {svc.valid} candidates: {per_ms:.0f} per ms of "
          f"batch wall time"
          + (f", {svc.valid / gather_ms:.0f} per ms of gather_rerank_topk" if gather_ms else "")
          + f" (Planner.candidates_per_ms default {tapi.Planner().candidates_per_ms:.0f}); "
          f"{card}")
    rows.update(candidates_per_ms=per_ms,
                candidates_per_gather_ms=svc.valid / gather_ms if gather_ms else None)
    counts = _path_counts("plan", ("alsh_project", "gather_rerank_topk",
                                   "gather_rerank_topk_blocked", "wl1_scan_topk"))
    return counts, rows


def _capture_kernel_calls(fn, names=("alsh_project", "gather_rerank_topk")):
    """Run ``fn`` with the entries ``names`` of ``ops`` spied on (by default
    ``alsh_project`` and ``gather_rerank_topk``; the streamed tail's group
    entry reaches the latter too) and return ``{name: [arguments, ...]}`` of
    their calls, in order, each a dict of every parameter by name."""
    import inspect

    from repro_torch.kernels import ops

    calls = {name: [] for name in names}
    orig = {name: getattr(ops, name) for name in calls}

    def spy(name):
        sig = inspect.signature(orig[name])

        def call(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            calls[name].append(dict(bound_args.arguments))
            return orig[name](*args, **kwargs)
        return call

    for name in calls:
        setattr(ops, name, spy(name))
    try:
        fn()
    finally:
        for name, f in orig.items():
            setattr(ops, name, f)
    return calls


def _kernel_shapes(run, path, calls_by_label, launches, two_seg=False):
    """``alsh_project`` and ``gather_rerank_topk`` timed on the inputs a path
    gave them (``calls_by_label`` from ``_capture_kernel_calls``; the
    broker's rung 0 at b=1 and b=64 and on the planner's b=64 calibration
    batch, the lm path's decode steps and datastore build): kernel and
    plain times, the bound, the kernel's agreement with its plain version,
    and launches x (time - bound) with the path's launch count of the
    kernel. With ``two_seg`` a gather over a delta segment is the
    two-segment kernel's; otherwise a delta fails the path (a sealed f32
    index's gathers)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    out = {"alsh_project": {}, "gather_rerank_topk": {}, "gather_rerank_topk_two_seg": {}}
    for label, calls in calls_by_label.items():
        if calls["alsh_project"]:
            a = calls["alsh_project"][-1]
            levels, folded, weights, tiled = a["levels"], a["folded"], a["weights"], a["tiled"]
            n, d = levels.shape
            H, _, m1 = folded.shape
            got = ops.alsh_project(levels, folded, weights, tiled=tiled)
            want = ops.alsh_project(levels, folded, weights, force="plain")
            err = float((got - want).abs().max())
            if err > PROJ_ATOL:
                raise AssertionError(f"alsh_project at {label}: kernel disagrees ({err})")
            ms = time_ms(lambda: ops.alsh_project(levels, folded, weights, tiled=tiled),
                         iters=20, warmup=2)
            plain_ms = time_ms(lambda: ops.alsh_project(levels, folded, weights,
                                                        force="plain"), iters=3)
            # library yardstick, as phase_alsh_project: the one-hot f32 product
            onehot = F.one_hot(levels.long(), m1).float()
            if weights is not None:
                onehot = onehot * weights[..., None]
            lhs = onehot.reshape(n, d * m1)
            rhs = folded.permute(1, 2, 0).reshape(d * m1, H).contiguous()
            lib_ms = time_ms(lambda: torch.matmul(lhs, rhs), iters=20, warmup=2)
            dev_us = device_us_per_call(f"alsh_project at {label}", lambda: ops.alsh_project(
                levels, folded, weights, tiled=tiled))
            wgt = weights is not None
            b_ms, b_by = bound(4 * (n * d * (2 if wgt else 1) + H * d * m1 + n * H),
                               n * H * d * (2 if wgt else 1))
            n_l = launches["alsh_project"]
            print(f"  [{path}] alsh_project at {label}: levels ({n}, {d}), H={H}: kernel "
                  f"{ms:.4f} ms (device per call {_fmt_us(dev_us)}), plain {plain_ms:.4f} ms, "
                  f"one-hot matmul {lib_ms:.4f} ms, bound {b_ms * 1e3:.2f} us by {b_by}; "
                  f"max_abs_err {err:.3g}; {path}-path launches {n_l} x (kernel - bound) = "
                  f"{n_l * (ms - b_ms):.1f} ms")
            out["alsh_project"][label] = {"n": n, "H": H, "ms": ms, "device_us": dev_us,
                                          "plain_ms": plain_ms, "library_ms": lib_ms,
                                          "bound_ms": b_ms, "bound_by": b_by,
                                          "max_abs_err": err}
        if calls["gather_rerank_topk"]:
            # the last call: a monolithic rung's only one, a streamed rung's
            # last per-group merge (the heap plus one group's windows)
            a = calls["gather_rerank_topk"][-1]
            data, ids, q, w, k, delta = (a[x] for x in ("data", "ids", "queries", "weights",
                                                         "k", "delta"))
            if a["scales"] is not None or (delta is not None and not two_seg):
                raise AssertionError(f"{label}: the {path}'s f32 sealed index gathered "
                                     f"with a delta or scales")
            name = "gather_rerank_topk" if delta is None else "gather_rerank_topk_two_seg"
            table = data if delta is None else torch.cat([data, delta])

            def gather(force=None):
                return ops.gather_rerank_topk(data, ids, q, w, k, delta=delta, force=force)

            got, want = gather(), gather(force="plain")
            torch.cuda.synchronize()
            err = _check_topk(f"[{path}] {name} at {label}", got, want, table, q, w)
            ms = time_ms(gather, iters=20, warmup=2)
            dev_us = device_us_per_call(f"{name} at {label}", gather)
            plain_ms = time_ms(lambda: gather(force="plain"), iters=1)
            b, P = ids.shape
            n_tot = table.shape[0]
            b_ms, b_by, *_ = gather_bound(ids, n_tot, data.shape[1], k, 4, scaled=False)
            n_g = launches[name]
            n_calls = len(calls["gather_rerank_topk"])
            print(f"  [{path}] {name} at {label}: ids ({b}, {P}) (the last of "
                  f"{n_calls} calls in the query), {int((ids < n_tot).sum()) / b:.1f} "
                  f"valid per query: kernel {ms:.4f} ms (device per call {_fmt_us(dev_us)}), "
                  f"plain {plain_ms:.4f} ms, library: none; bound "
                  f"{b_ms * 1e3:.2f} us by {b_by}; {path}-path launches {n_g} x (kernel - "
                  f"bound) = {n_g * (ms - b_ms):.1f} ms")
            out[name][label] = {"b": b, "P": P, "calls_in_query": n_calls,
                                                "ms": ms, "device_us": dev_us,
                                                "plain_ms": plain_ms, "library_ms": None,
                                                "bound_ms": b_ms, "bound_by": b_by,
                                                "max_abs_err": err}
    for name, shapes in out.items():
        if shapes:
            run.kernels.setdefault(name, {})[f"{path}_shapes"] = shapes
    return {name: shapes for name, shapes in out.items() if shapes}


def _broker_stats(label, responses, stats, n_requests, ladder):
    """Checks every broker run holds — one response per request, a degraded
    answer labeled with its rung's prediction — and prints its figures."""
    rids = sorted(r.rid for r in responses)
    if rids != list(range(n_requests)):
        raise AssertionError(f"{label}: {len(responses)} responses for {n_requests} requests "
                             f"(every request must get exactly one)")
    for r in responses:
        if r.rung > 0 and r.status != "shed":
            spec = ladder[r.rung]
            if (r.status != "degraded" or r.predicted_recall != float(spec.predicted_recall)
                    or r.predicted_success != float(spec.predicted_success)):
                raise AssertionError(f"{label}: response {r.rid} at rung {r.rung} is not "
                                     f"labeled with its rung's prediction")
    print(f"  [broker] {label}: p50 {stats.p50_ms:.3f} ms, p99 {stats.p99_ms:.3f} ms, "
          f"throughput {stats.throughput_rps:.0f} req/s, served {stats.served}, shed rate "
          f"{stats.shed_rate:.4f}, degraded fraction {stats.degraded_frac:.4f}, rung counts "
          f"{dict(sorted(stats.rung_counts.items()))}, degrades {stats.degrades}, recoveries "
          f"{stats.recoveries}, mean coverage {stats.mean_coverage:.4f}")
    return {"p50_ms": stats.p50_ms, "p99_ms": stats.p99_ms,
            "throughput_rps": stats.throughput_rps, "served": stats.served,
            "shed_rate": stats.shed_rate, "degraded_frac": stats.degraded_frac,
            "rung_counts": {str(k): v for k, v in sorted(stats.rung_counts.items())},
            "degrades": stats.degrades, "recoveries": stats.recoveries,
            "mean_coverage": stats.mean_coverage}


def phase_broker_path(run, svc, card):
    """The serving tier at the SERVICE width (n=262,144, d=128, k=10) on one
    card, launch counts zeroed before its build (``serve --mode broker``'s
    flow, with the rates derived as ``benchmarks/serving_bench.py`` derives
    them):

    1. ``Index.build(seed, rows, QualitySpec(k=10, recall_target=0.9),
       family="theta", M=32)`` with the default planner and its ladder
       (the target raised to 0.95, then 0.99, while the ladder has one
       rung): each rung's mode, probes, window, early exit, predicted
       recall and recall@10 against exact mode on 64 held-out queries; a
       ladder of one rung at the last target fails the path;
    2. a ``Broker`` (``max_batch=64, max_queue=256``) warms every (bucket,
       rung); then each rung is timed at buckets 1, 8 and 64 through the
       broker's own ``_execute`` (the answer copied to the host inside the
       window), the device busy time of each rung at b=64, and every rung
       the card serves slower than the rung above it;
    3. two traces of 2000 requests, rates from rung 0's b=64 time t
       (capacity 64 / t): Poisson at 0.6x capacity and bursty at 0.3x
       base / 2.4x bursts, period max(0.05 s, 50 t); SLO p99 = max(5 ms,
       4 t); measured service time. Each: no kernel built after warmup,
       one response per request, every degraded answer labeled;
    4. a ``ShardSet`` of 4 shards (65,536 rows each) on the card: its build
       and save seconds, exact mode equal to the single index's (ids equal,
       dists within 1e-5), then the chaos drill on the Poisson trace: shard
       1 killed at the 500th arrival, 2 injected recovery failures, backoff
       base 2 t, cap 0.5 s. Checks: coverage 0.75 seen, the recovery log
       ``killed, recover_failed, recover_failed, recovered``, no row of the
       dead shard while it is down, answers after recovery bit-identical to
       those before;
    5. after the path's counts are read: ``alsh_project`` and
       ``gather_rerank_topk`` timed at rung 0's shapes (b=1, b=64, and the
       planner's b=64 calibration batch), see ``_kernel_shapes``."""
    import os
    import tempfile

    import numpy as np
    import torch

    import repro_torch.api as tapi
    from repro_torch import serving
    from repro_torch.analysis import RetraceGuard
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    wl = svc.wl
    k = SERVICE.topk
    exact = tapi.QuerySpec(k=k, mode="exact")
    hq, hw = wl.batch(BROKER_MAX_BATCH, SEED + 9200)
    hq_np, hw_np = hq.cpu().numpy(), hw.cpu().numpy()
    tq, tw = (t.cpu().numpy() for t in wl.batch(256, SEED + 9300))
    rows = {"card": card}
    _build.reset_launch_counts()

    # 1. the quality build and its ladder: the first target whose ladder
    # leaves the broker a rung to degrade to
    for target in BROKER_TARGETS:
        quality = tapi.QualitySpec(k=PLAN_K, recall_target=target)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index = tapi.Index.build(SEED + 2, wl.data, quality, family="theta", M=32)
        ladder = index.plan_ladder(quality)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        print(f"  [broker] recall_target {target}: built+planned n={index.n} d={index.d} on "
              f"{index.device} in {build_s:.3f} s: {index.config}; ladder has {len(ladder)} "
              f"rung(s)")
        if len(ladder) >= 2:
            break
    ref = index.query(hq, hw, exact)
    rungs = []
    for r, spec in enumerate(ladder):
        held = recall_at_k(index.query(hq, hw, spec).ids, ref.ids, k)
        print(f"  [broker]   rung {r}: {spec.mode} probes {spec.n_probes} window "
              f"{spec.max_candidates} early_exit {spec.early_exit}; predicted_recall "
              f"{spec.predicted_recall:.4f}, held-out recall@{k} {held:.4f}")
        rungs.append({"mode": spec.mode, "n_probes": spec.n_probes,
                      "window": spec.max_candidates, "early_exit": spec.early_exit,
                      "predicted_recall": spec.predicted_recall, "held_out_recall": held})
    if len(ladder) < 2:
        raise AssertionError("the ladder has one rung: the broker has nothing to degrade to")
    rows.update(recall_target=quality.recall_target, build_s=build_s, config=str(index.config),
                rungs=rungs)

    # 2. warmup, then every rung at buckets 1, 8, 64
    cfg = serving.BrokerConfig(max_batch=BROKER_MAX_BATCH, max_queue=BROKER_MAX_QUEUE)
    slo_probe = serving.SLOConfig(p99_ms=1e9)
    loads0 = RetraceGuard().snapshot()
    t0 = time.perf_counter()
    broker = serving.Broker(index, quality, slo_probe, cfg)
    warm_s = time.perf_counter() - t0
    print(f"  [broker] warmup of {len(broker.buckets)} buckets x {len(ladder)} rungs: "
          f"{warm_s:.3f} s; kernel libraries loaded since the path began: "
          f"{_build.library_loads() - loads0}")
    grid = {}
    for r, spec in enumerate(ladder):
        for b in BROKER_BUCKETS:
            times = sorted(broker._execute(hq_np[:b], hw_np[:b], spec, 0.0)[3] * 1e3
                           for _ in range(BROKER_REPS))
            grid[(r, b)] = times[BROKER_REPS // 2]
    busy = {}
    for r, spec in enumerate(ladder):
        busy[r] = profile(f"of rung {r} at b={BROKER_MAX_BATCH}",
                          lambda: index.query(hq, hw, spec), top=4)
    for r in range(len(ladder)):
        print(f"  [broker] rung {r}: ms per batch "
              + ", ".join(f"b={b} {grid[(r, b)]:.3f}" for b in BROKER_BUCKETS)
              + f"; device busy at b={BROKER_MAX_BATCH} {_fmt_us(busy[r])}")
    inversions = {b: [r for r in range(1, len(ladder)) if grid[(r, b)] > grid[(r - 1, b)]]
                  for b in BROKER_BUCKETS}
    print(f"  [broker] rungs served slower than the rung above them, by bucket: {inversions}; "
          f"{card}")
    t_s = grid[(0, BROKER_MAX_BATCH)] / 1e3
    capacity = BROKER_MAX_BATCH / t_s
    slo_ms = max(5.0, 4e3 * t_s)
    print(f"  [broker] rung 0 at b={BROKER_MAX_BATCH}: t = {t_s * 1e3:.3f} ms -> capacity "
          f"{capacity:.0f} req/s; SLO p99 {slo_ms:.3f} ms")
    rows.update(warmup_s=warm_s, ms_by_rung_bucket={f"{r}/{b}": v for (r, b), v in grid.items()},
                busy_us_b64=busy, inversions=inversions, t_ms=t_s * 1e3, capacity_rps=capacity,
                slo_p99_ms=slo_ms)
    del broker

    # 3. the two traces
    slo = serving.SLOConfig(p99_ms=slo_ms)
    poisson = serving.poisson_trace(0.6 * capacity, BROKER_REQUESTS, seed=0)
    bursty = serving.bursty_trace(0.3 * capacity, 2.4 * capacity, BROKER_REQUESTS, seed=1,
                                  period_s=max(0.05, 50 * t_s))
    for label, trace in (("poisson 0.6x", poisson), ("bursty 0.3x/2.4x", bursty)):
        broker = serving.Broker(index, quality, slo, cfg)
        t0 = time.perf_counter()
        responses, stats = broker.run(serving.requests_from_trace(trace, tq, tw))
        wall_s = time.perf_counter() - t0
        broker.assert_no_retrace()
        print(f"  [broker] {label} trace: {BROKER_REQUESTS} requests over {trace[-1]:.3f} s "
              f"of arrivals, served in {wall_s:.3f} s wall; no kernel built after warmup")
        rows[label] = _broker_stats(label, responses, stats, BROKER_REQUESTS, ladder)
        rows[label]["wall_s"] = wall_s
        del broker, responses

    # 4. the shard set and the chaos drill
    timed = {"save": 0.0, "load": 0.0}
    orig_save, orig_load = tapi.Index.save, tapi.Index.load.__func__

    def timed_save(self, directory):
        t = time.perf_counter()
        try:
            return orig_save(self, directory)
        finally:
            timed["save"] += time.perf_counter() - t

    def timed_load(cls, directory, device=None):
        t = time.perf_counter()
        try:
            return orig_load(cls, directory, device=device)
        finally:
            torch.cuda.synchronize()
            timed["load"] += time.perf_counter() - t

    with tempfile.TemporaryDirectory(prefix="chip_smoke_shards_") as tmp:
        tapi.Index.save, tapi.Index.load = timed_save, classmethod(timed_load)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ss = serving.ShardSet.build(index, BROKER_SHARDS, os.path.join(tmp, "shards"))
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            built = dict(timed)
            sizes = [sum(f.stat().st_size for f in Path(dr).rglob("*") if f.is_file())
                     for dr in ss.dirs]
            print(f"  [broker] ShardSet of {ss.n_shards} x {index.n // ss.n_shards} rows on "
                  f"{ss.device}: {total_s:.3f} s in all, of it save {built['save']:.3f} s and "
                  f"load {built['load']:.3f} s (build {total_s - built['save'] - built['load']:.3f}"
                  f" s); {sum(sizes)} B on disk; {card}")
            got = ss.query(hq_np, hw_np, exact)
            same_ids = np.array_equal(got.ids, ref.ids.cpu().numpy())
            dist_ok = np.allclose(got.dists, ref.dists.cpu().numpy(), rtol=DIST_RTOL,
                                  atol=DIST_ATOL)
            print(f"  [broker] shard-exact + host merge vs the single index's exact mode on "
                  f"{BROKER_MAX_BATCH} queries: ids equal {same_ids}, dists within "
                  f"{DIST_RTOL}: {dist_ok}, coverage {got.coverage}")
            if not (same_ids and dist_ok and got.coverage == 1.0):
                raise AssertionError("the shard set's exact mode differs from the single index's")
            pre = ss.query(hq_np, hw_np, ladder[0])
            kill_at = float(poisson[BROKER_KILL_AT - 1])
            ss.chaos = serving.ChaosPlan(kill_shard=1, kill_at_s=kill_at, recovery_failures=2,
                                         backoff_base_s=2 * t_s, backoff_cap_s=0.5)
            broker = serving.Broker(index, quality, slo, cfg, shardset=ss)
            t0 = time.perf_counter()
            responses, stats = broker.run(serving.requests_from_trace(poisson, tq, tw))
            wall_s = time.perf_counter() - t0
            broker.assert_no_retrace()
            chaos = _broker_stats("chaos (poisson 0.6x, 4 shards)", responses, stats,
                                  BROKER_REQUESTS, ladder)
            served = [r for r in responses if r.status != "shed"]
            covs = sorted({round(r.coverage, 6) for r in served})
            events = [e["event"] for e in ss.recovery_log]
            lo, hi = ss.offsets[1], ss.offsets[1] + index.n // ss.n_shards
            leaked = sum(int(((r.ids >= lo) & (r.ids < hi)).any()) for r in served
                         if r.coverage < 1.0)
            post = ss.query(hq_np, hw_np, ladder[0])
            same = np.array_equal(pre.ids, post.ids) and np.array_equal(pre.dists, post.dists)
            print(f"  [broker] chaos: kill shard 1 at t={kill_at:.4f} s (arrival "
                  f"{BROKER_KILL_AT}); coverages seen {covs}; recovery log "
                  + ", ".join(f"{e['event']}@{e['t_s']:.4f}" for e in ss.recovery_log)
                  + f"; answers with a dead-shard row while it was down: {leaked}; after "
                  f"recovery bit-identical to before: {same}; {wall_s:.3f} s wall")
            if 0.75 not in covs or events != ["killed", "recover_failed", "recover_failed",
                                             "recovered"]:
                raise AssertionError(f"chaos drill: coverages {covs}, events {events}")
            if leaked or not same or ss.coverage != 1.0:
                raise AssertionError("chaos drill: a dead shard's row answered, or the "
                                     "recovered set answers differently")
            chaos.update(coverages=covs, events=events, kill_at_s=kill_at, wall_s=wall_s)
            rows.update(shards_s=total_s, shards_save_s=built["save"],
                        shards_load_s=built["load"], shards_bytes=sum(sizes), chaos=chaos)
            del broker, responses, ss
        finally:
            tapi.Index.save, tapi.Index.load = orig_save, classmethod(orig_load)
    counts = _path_counts("broker", ("alsh_project", "gather_rerank_topk", "wl1_scan_topk"))
    if _build.library_loads() != loads0:
        raise AssertionError("the broker path built or loaded a kernel library")

    # 5. the kernels at rung 0's shapes (launch counts already read)
    qs, ws, _ = tapi.Planner()._calibration_sample(index, quality)
    calls = {
        f"rung 0, b={b}": _capture_kernel_calls(lambda b=b: index.query(hq[:b], hw[:b],
                                                                        ladder[0]))
        for b in (1, BROKER_MAX_BATCH)
    }
    calls[f"rung 0, calibration batch b={qs.shape[0]}"] = _capture_kernel_calls(
        lambda: index.query(qs, ws, ladder[0]))
    rows["kernel_shapes"] = _kernel_shapes(run, "broker", calls, counts)
    print(f"  [broker] summary {json.dumps(rows, default=str)}")
    return counts, rows


def _at_least(label, launches, names, S):
    """Fails unless each named kernel launched at least ``S`` times (once
    per shard) in the call whose ``launches`` are given."""
    low = {n: launches.get(n, 0) for n in names if launches.get(n, 0) < S}
    print(f"  [sharded] {label}: launches {launches}")
    if low:
        raise AssertionError(f"{label}: fewer than {S} launches (one per shard): {low}")


def _exact_pair(label, sharded_res, single_res):
    """Exact mode sharded against single-host: ids equal, dists within
    DIST_RTOL/DIST_ATOL; prints whether the dists are also bit-equal."""
    import torch

    same_ids = torch.equal(sharded_res.ids, single_res.ids)
    close = torch.allclose(sharded_res.dists, single_res.dists, rtol=DIST_RTOL, atol=DIST_ATOL)
    bits = torch.equal(sharded_res.dists, single_res.dists)
    err = float((sharded_res.dists - single_res.dists).nan_to_num(0, 0, 0).abs().max())
    print(f"  [sharded] {label}: ids equal {same_ids}, dists within rtol/atol {DIST_RTOL} "
          f"{close} (max_abs_err {err:.3g}), bit-equal {bits}")
    if not (same_ids and close):
        raise AssertionError(f"{label}: the sharded exact answer differs from the single host's")
    return bits


def phase_sharded_path(svc, card):
    """The sharded service on the card: SERVICE.n_per_shard rows on each of
    the eight shards of a (2, 2, 2) mesh of the one card, against the
    single-host index over all 2,097,152 rows (see the module docstring)."""
    import dataclasses

    import torch

    import repro_torch.api as tapi
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.core import distributed as tdist
    from repro_torch.core.index import build_index
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build

    cfg = svc.index.config
    S = math.prod(SHARD_MESH)
    n_local, k, b = SERVICE.n_per_shard, SERVICE.topk, SERVICE.query_batch
    _build.reset_launch_counts()
    wl = Workload(S * n_local, cfg.d, seed=SEED + 60)
    # permute before the partition: otherwise every cluster sits in one shard
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    wl.data = wl.data[torch.randperm(wl.data.shape[0], generator=gen, device="cuda")]
    q, w = wl.batch(b, SEED + 62)
    mesh = tdist.make_mesh(SHARD_MESH, SHARD_AXES, devices=[torch.device("cuda", 0)] * S)
    spec = tapi.QuerySpec(k=k)
    mspec = tapi.QuerySpec(k=k, mode="multiprobe", n_probes=8, max_flips=3)
    exact = tapi.QuerySpec(k=k, mode="exact")
    out = {"card": card, "n": S * n_local, "shards": S}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = tapi.Index.build(SEED + 2, wl.data, cfg)
    torch.cuda.synchronize()
    out["single_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sharded = single.shard(mesh)
    torch.cuda.synchronize()
    out["shard_s"] = time.perf_counter() - t0
    print(f"  [sharded] single-host index over n={single.n} in {out['single_build_s']:.3f} s; "
          f"Index.shard onto {mesh} ({S} x {n_local} rows) in {out['shard_s']:.3f} s ({card})")

    # 1. probe: both merges, the shards' own answers, recall
    res, launches = _launched(lambda: sharded.query(q, w, spec))
    _check_result(res, b, k)
    _at_least("probe batch", launches, ("alsh_project", "gather_rerank_topk"), S)
    flat = dataclasses.replace(sharded, merge_hierarchical=False).query(q, w, spec)
    same_flat = all(torch.equal(getattr(res, f), getattr(flat, f))
                    for f in ("ids", "dists", "n_candidates"))
    local = tdist.local_results(sharded.index_sharded, q, w, cfg, spec)
    summed = torch.stack([r.n_candidates for r in local]).sum(0, dtype=torch.int32)
    same_nc = torch.equal(res.n_candidates, summed)
    alone = tapi.Index(state=build_index(None, wl.data[:n_local], cfg, tables=single.state.tables,
                                         mixers=single.state.mixers), config=cfg)
    own = alone.query(q, w, spec)
    g0 = tdist.globalize_ids(local[0].ids, 0, S, n_local)
    same_0 = (torch.equal(g0, own.ids) and torch.equal(local[0].dists, own.dists)
              and torch.equal(local[0].n_candidates, own.n_candidates))
    ex64 = sharded.query(q[:SHARD_CHECK], w[:SHARD_CHECK], exact)
    rec = recall_at_k(res.ids[:SHARD_CHECK], ex64.ids, k)
    single_res = single.query(q, w, spec)
    rec_single = recall_at_k(single_res.ids[:SHARD_CHECK],
                             single.query(q[:SHARD_CHECK], w[:SHARD_CHECK], exact).ids, k)
    out["probe_ms"] = _median_ms(sharded, q, w, spec)
    out["single_probe_ms"] = _median_ms(single, q, w, spec)
    out["probe_busy_us"] = profile("of one sharded probe batch (8 shards, one card)",
                                   lambda: sharded.query(q, w, spec), unprofiled_wall=True)
    out["single_probe_busy_us"] = profile("of one single-host probe batch (n=2,097,152)",
                                          lambda: single.query(q, w, spec), top=6)
    cand = float(res.n_candidates.float().mean())
    out.update(recall=rec, recall_single=rec_single, cand_frac=cand / single.n,
               cand_frac_single=float(single_res.n_candidates.float().mean()) / single.n)
    print(f"  [sharded] probe: {b} queries in {out['probe_ms']:.2f} ms (median of 5; single-host "
          f"{out['single_probe_ms']:.2f} ms), cand_frac {out['cand_frac']:.5f} (single-host "
          f"{out['cand_frac_single']:.5f}), recall@{k} {rec:.3f} (single-host {rec_single:.3f}, "
          f"floor {THETA_RECALL_FLOOR}); hierarchical == flat bit for bit: {same_flat}; "
          f"n_candidates == the shards' sum: {same_nc}; shard 0 == a single-host index over its "
          f"rows: {same_0}")
    if not (same_flat and same_nc and same_0):
        raise AssertionError("sharded probe: merge, candidate count or shard 0 disagrees")
    if rec < THETA_RECALL_FLOOR:
        raise AssertionError(f"sharded probe recall@{k} {rec:.3f} under {THETA_RECALL_FLOOR}")

    # 2. multiprobe
    mp, launches = _launched(lambda: sharded.query(q, w, mspec))
    _check_result(mp, b, k)
    _at_least("multiprobe batch", launches, ("alsh_project", "gather_rerank_topk"), S)
    worse = int((mp.dists > res.dists + 1e-6).sum())
    out["multiprobe_ms"] = _median_ms(sharded, q, w, mspec, reps=3)
    print(f"  [sharded] multiprobe (8 probes, 3 flips): {out['multiprobe_ms']:.2f} ms (median "
          f"of 3), cand_frac {float(mp.n_candidates.float().mean()) / single.n:.5f}; slots "
          f"worse than probe: {worse}")
    if worse or not bool((mp.n_candidates >= res.n_candidates).all()):
        raise AssertionError("sharded multiprobe must see a superset of the probe's candidates")

    # 3. exact mode against the single-host index over all rows
    ex, launches = _launched(lambda: sharded.query(q, w, exact))
    _at_least("exact batch", launches, ("wl1_scan_topk",), S)
    out["exact_bit_equal"] = _exact_pair(f"exact, b={b}", ex, single.query(q, w, exact))
    out["exact_ms"] = _median_ms(sharded, q, w, exact, reps=3)
    out["single_exact_ms"] = _median_ms(single, q, w, exact, reps=3)
    print(f"  [sharded] exact: {out['exact_ms']:.2f} ms (single-host {out['single_exact_ms']:.2f})")
    del sharded, single, alone, local, flat

    # 4. mutable: two stream ticks on one host, then shard; lockstep after
    update = tapi.UpdateSpec(delta_capacity=SHARD_CAP)
    host = tapi.Index.build(SEED + 2, wl.data, cfg, update=update)
    for t in range(1, SHARD_TICKS + 1):
        centres, rows = stream_rows(SEED + 5000 + t, STREAM_INGEST // CLUSTER, cfg.d)
        host = host.insert(rows)[0].delete(torch.arange((t - 1) * STREAM_RETIRE,
                                                        t * STREAM_RETIRE, device="cuda"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msh = host.shard(mesh)
    torch.cuda.synchronize()
    out["shard_mutable_s"] = time.perf_counter() - t0
    fills = [d.fill for d in msh.delta_sharded]
    print(f"  [sharded] mutable: delta {host.delta_fill}/{SHARD_CAP}, "
          f"{int(host.tombstones.sum())} tombstones; sharded in {out['shard_mutable_s']:.3f} s, "
          f"fills {fills}")
    if msh.delta_fill != host.delta_fill or len(set(fills)) != 1:
        raise AssertionError(f"the replayed delta is not striped evenly: {fills}")
    q2, w2 = stream_batch(wl, centres, SEED + 6000)
    qc, wc = q2[:SHARD_CHECK], w2[:SHARD_CHECK]
    mex, launches = _launched(lambda: msh.query(qc, wc, exact))
    _at_least("mutable exact", launches, ("gather_rerank_topk_two_seg",), S)
    out["mutable_exact_bit_equal"] = _exact_pair(f"mutable exact, b={SHARD_CHECK}", mex,
                                                 host.query(qc, wc, exact))
    rows = stream_rows(SEED + 5100, STREAM_INGEST // CLUSTER, cfg.d)[1]
    host, ids_h = host.insert(rows)
    msh, ids_s = msh.insert(rows)
    same_ids = torch.equal(ids_h, ids_s) and bool((ids_s >= 0).all())
    dels = torch.cat([ids_h[:16].long(), torch.arange(1024, 1152, device="cuda")])
    host, msh = host.delete(dels), msh.delete(dels)
    mp_res, launches = _launched(lambda: msh.query(q2, w2, spec))
    _check_result(mp_res, b, k)
    _at_least("mutable probe", launches, ("alsh_project", "gather_rerank_topk_two_seg"), S)
    mex2 = msh.query(qc, wc, exact)
    bits2 = _exact_pair("mutable exact after the lockstep insert and deletes", mex2,
                        host.query(qc, wc, exact))
    for label, r in (("mutable probe", mp_res), ("mutable exact", mex2)):
        _no_dead_ids(f"sharded {label}", r, host.tombstones)
    hit = float((mp_res.ids[:STREAM_ON_NEW] >= host.n).any(dim=1).float().mean())
    out["mutable_probe_ms"] = _median_ms(msh, q2, w2, spec)
    print(f"  [sharded] lockstep insert of {rows.shape[0]}: gids equal {same_ids}; deleted "
          f"{dels.numel()} ids, none in a result; mutable probe {out['mutable_probe_ms']:.2f} ms, "
          f"delta hits {hit:.3f} of the {STREAM_ON_NEW} queries on new centres")
    if not same_ids:
        raise AssertionError("the sharded insert assigned other gids than the single host")
    out["mutable_exact_bit_equal_after"] = bits2

    # compact: sharded against single-host, leaf for leaf by bits
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cs = msh.compact()
    torch.cuda.synchronize()
    out["compact_sharded_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ch = host.compact()
    torch.cuda.synchronize()
    out["compact_single_s"] = time.perf_counter() - t0
    pairs = [(f, getattr(cs.state, f), getattr(ch.state, f))
             for f in ("mixers", "sorted_keys", "perm", "data", "levels")]
    pairs += [(f"tables.{f}", getattr(cs.state.tables, f), getattr(ch.state.tables, f))
              for f in ("folded", "offsets", "tiled")]
    bad = [name for name, x, y in pairs
           if (x is None) != (y is None) or (x is not None and not torch.equal(x, y))]
    print(f"  [sharded] compact: sharded {out['compact_sharded_s']:.3f} s, single-host "
          f"{out['compact_single_s']:.3f} s, n={cs.n}; {len(pairs)} leaves compared, unequal: "
          f"{bad or 'none'}")
    if bad or cs.n != ch.n:
        raise AssertionError(f"the sharded compact differs from the single-host one: {bad}")
    counts = _path_counts("sharded", ("alsh_project", "gather_rerank_topk",
                                      "gather_rerank_topk_two_seg", "wl1_scan_topk"))
    print(f"  [sharded] numbers: {json.dumps(out)}")
    return counts, out


# The static-contract phase: the kernels the audit lattice launches on the card
# (wl1_scan and wl1_rerank lie only on the unfused path)
LATTICE_KERNELS = ("alsh_project", "gather_rerank_topk", "gather_rerank_topk_two_seg",
                   "gather_rerank_topk_blocked", "gather_rerank_topk_blocked_two_seg",
                   "wl1_scan_topk")
SYNC_WARNING = "called a synchronizing CUDA operation"


def _batch_contracts(label, fn):
    """One SERVICE batch (warmed up first) under the audit's tracker: its peak
    live bytes, the CUDA allocator's peak above the pre-call baseline and the
    dtype findings (a finding fails the run), then the host syncs of a second
    call, counted as the warnings of ``torch.cuda.set_sync_debug_mode("warn")``,
    by the line that made them (printed, not budgeted)."""
    import collections
    import warnings

    import torch

    from repro_torch.analysis import audit

    fn()
    tracker, _, alloc = audit.measure(fn, "cuda")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the Python line that made each synchronizing call
    where = collections.Counter(f"{w.filename.split('/src/')[-1]}:{w.lineno}" for w in caught
                                if SYNC_WARNING in str(w.message))
    syncs = sum(where.values())
    torch.cuda.synchronize()
    dtype_findings = sorted(set(tracker.violations))
    print(f"  [{label}] tracker peak {tracker.peak} B ({tracker.peak / 2**20:.1f} MiB), "
          f"allocator peak {alloc} B ({alloc / 2**20:.1f} MiB), host syncs per batch {syncs} "
          f"({', '.join(f'{k} x{n}' for k, n in sorted(where.items()))}), "
          f"dtype findings {len(dtype_findings)}")
    for msg in dtype_findings:
        print(f"    AUD003 {msg}")
    if dtype_findings:
        raise AssertionError(f"{label}: the SERVICE batch breaks the dtype contract")
    return {"tracker_peak_bytes": tracker.peak, "allocator_peak_bytes": alloc,
            "syncs_per_batch": syncs, "syncs_by_line": dict(where)}


def _against_cpu(label, got, want, table, q, w):
    """One answer of the card against the CPU plain path's on the same
    inputs: equal ``n_candidates`` (and, on the streamed tail, equal
    ``tables_probed`` and ``stop_reason``), then ``_check_topk``."""
    import torch

    for f in ("n_candidates", "tables_probed", "stop_reason"):
        a, b = getattr(got, f), getattr(want, f)
        if (a is None) != (b is None) or (a is not None and not torch.equal(a.cpu(), b)):
            raise AssertionError(f"{label}: {f} differs between the card and the CPU")
    return _check_topk(label, (got.dists.cpu(), got.ids.cpu()), (want.dists, want.ids), table,
                       q, w, quiet=True)


def _lattice_against_cpu(device="cuda"):
    """The answers behind the static-contract launches, held against the CPU
    plain path on the same inputs: every compile key's first lattice point
    at the audit geometry (n=4096, d=16, b=8, C=64/32, f32/bf16/int8, theta
    and l2), over two index states — the audit's own (an empty delta of
    4096 rows) and one with a quarter of the delta filled and rows of both
    segments deleted — and the live probe's four warm calls (d=4). The
    queries are random and non-zero (zero queries hash every row of a batch
    alike). Returns (comparisons, worst max_abs_err)."""
    import dataclasses

    import torch

    from repro_torch import quant
    from repro_torch.analysis import audit, budgets

    g = budgets.AUDIT_GEOMETRY
    gen = torch.Generator().manual_seed(SEED + 23)
    q = torch.rand((g["b"], g["d"]), generator=gen)
    w = 0.5 + torch.rand((g["b"], g["d"]), generator=gen)
    rows = torch.rand((g["delta_capacity"] // 4, g["d"]), generator=gen)
    dead = torch.randperm(g["n"], generator=gen)[:256].to(torch.int32)
    qc, wc = q.to(device), w.to(device)
    audited = audit.build_audit_indexes(device)
    filled = {}
    for key, idx in audited.items():
        idx, ids = idx.insert(rows.to(device))
        filled[key] = idx.delete(torch.cat([dead.to(device), ids[::16]]))
    firsts = {}
    for p in audit.enumerate_points():
        firsts.setdefault(audit.compile_key(p, audited[(p.family, p.storage)], qc, wc), p)
    n_cmp, worst = 0, 0.0
    for state_label, indexes in (("empty delta", audited), ("delta 1024 filled, 320 deleted",
                                                            filled)):
        for key, idx in indexes.items():
            cpu = dataclasses.replace(idx, state=idx.state.to("cpu"), delta=idx.delta.to("cpu"),
                                      tombstones=idx.tombstones.cpu())
            tables = {"sealed": quant.decode_table(cpu.state.data, cpu.state.scales),
                      "segmented": quant.decode_table(torch.cat([cpu.state.data,
                                                                 cpu.delta.data]),
                                                      cpu.state.scales)}
            for p in firsts.values():
                if (p.family, p.storage) != key:
                    continue
                got = audit.query_point(p, idx, qc, wc)
                want = audit.query_point(p, cpu, q, w)
                err = _against_cpu(f"{p.name} ({state_label})", got, want, tables[p.view], q, w)
                n_cmp, worst = n_cmp + 1, max(worst, err)
    state, cfg, lq, lw = audit.live_probe_inputs(device)
    cstate = state.to("cpu")
    for name, args in audit.LIVE_PROBE_PROGRAMS.items():
        got = audit.live_probe_call(state, cfg, lq, lw, *args)
        want = audit.live_probe_call(cstate, cfg, lq.cpu(), lw.cpu(), *args)
        err = _against_cpu(f"live probe {name}", got, want, cstate.data, lq.cpu(), lw.cpu())
        n_cmp, worst = n_cmp + 1, max(worst, err)
    return n_cmp, worst


def phase_static_contracts(svc, card):
    """The static-contract gate on the card (``repro_torch.analysis``): the
    port's tree lints clean; the audit lattice on the card (146 raw points
    -> 64 compile keys, every path under the envelope, no dtype finding, no
    drift against ``golden_budget_cuda.json``), with the launch counters
    zeroed just before it and read just after; both seeded regressions fail
    as named (AUD001, AUD002); every compile key's answer at the audit
    geometry, and the live probe's, agree with the CPU plain path's
    (``_lattice_against_cpu``); the live normalization probe is bit-equal
    under a ``RetraceGuard``. Then six SERVICE batches — f32 probe, int8
    screened, multiprobe, exact, a stream batch at tick 12 and a streamed
    early-exit batch — each with the tracker's and the allocator's peak
    bytes (a dtype finding fails) and its host syncs (printed, not
    budgeted)."""
    import dataclasses

    import torch

    import repro_torch.api as tapi
    from repro_torch.analysis import RetraceGuard, audit, budgets, lint_paths
    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    src = ROOT / "src"
    findings = lint_paths([src / "repro_torch"], root=src)
    for f in findings:
        print(f"  {f}")
    print(f"  lint: {len(findings)} finding(s)")
    if findings:
        raise AssertionError("the port's tree does not lint clean")

    golden = audit.load_golden("cuda")
    if golden is None:
        raise AssertionError("src/repro_torch/analysis/golden_budget_cuda.json is missing")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    report = audit.run_audit(golden=golden, live_probe=False, device="cuda")
    audit_s = time.perf_counter() - t0
    counts = _path_counts("static_contracts", LATTICE_KERNELS)
    ck, mem = report["compile_keys"], report["memory"]
    print(f"  audit (cuda): {ck['raw_points']} raw lattice points -> {ck['count']} compile keys "
          f"(budget {ck['budget']}); worst path {mem['worst_path']} at "
          f"{mem['max_peak_live_bytes']} B (envelope {mem['envelope_bytes']} B); "
          f"int8 went into ops {report['int8_ops']}; {audit_s:.1f} s")
    for row in report["paths"]:
        extra = f" int8 into {row['int8_kernels']}" if "int8_kernels" in row else ""
        print(f"    {row['name']:42s} tracker {row['peak_live_bytes']:>9d} B  allocator "
              f"{row.get('allocator_peak_bytes', 0):>9d} B  x{row['raw_variants']}  "
              f"{row['launches']}{extra}")
    for f in report["failures"]:
        print(f"  {f['code']} {f['path']}: {f['message']}")
    if report["failures"] or (ck["raw_points"], ck["count"]) != (146, budgets.RETRACE_BUDGET):
        raise AssertionError(f"the audit failed on the card: {len(report['failures'])} failures")
    bad_int8 = [row["name"] for row in report["paths"] if "int8_kernels" in row
                and set(row["launches"]) - {"alsh_project", "wl1_scan_topk", *audit.STORED_KERNELS}]
    if bad_int8:
        raise AssertionError(f"int8 paths launched a kernel outside the stored-type gathers: "
                             f"{bad_int8}")

    for inject, code in (("memory", "AUD001"), ("retrace", "AUD002")):
        t0 = time.perf_counter()
        seeded = audit.run_audit(inject=inject, live_probe=False, device="cuda")
        hits = [f for f in seeded["failures"] if f["code"] == code]
        print(f"  seeded {inject} regression: ok={seeded['ok']}, {len(hits)} {code} "
              f"(e.g. {hits[0]['path']}: measured {hits[0]['measured']:g} vs budget "
              f"{hits[0]['budget']:g}) in {time.perf_counter() - t0:.1f} s" if hits else
              f"  seeded {inject} regression: no {code}")
        if seeded["ok"] or not hits:
            raise AssertionError(f"the seeded {inject} regression did not fail with {code}")
        if inject == "memory" and not all("/segmented/" in f["path"] for f in hits):
            raise AssertionError("the memory regression breached a sealed path")

    t0 = time.perf_counter()
    n_cmp, worst = _lattice_against_cpu()
    print(f"  card vs the CPU plain path: {n_cmp} answers (64 compile keys x 2 index states "
          f"+ the live probe's 4 programs), all with equal n_candidates, max_abs_err {worst:.3g} "
          f"(rtol/atol {DIST_RTOL}), no id mismatch but genuine ties; "
          f"{time.perf_counter() - t0:.1f} s")

    with RetraceGuard() as guard:
        loads = guard.baseline
        probe_failures = audit.live_normalization_probe("cuda")
    for f in probe_failures:
        print(f"  {f}")
    print(f"  live normalization probe: {len(probe_failures)} failure(s); every variant "
          f"bit-equal to its normalized twin with equal launches; library_loads "
          f"{loads} -> {_build.library_loads()}")
    if probe_failures:
        raise AssertionError("the live normalization probe failed on the card")

    # six SERVICE batches: peak bytes and host syncs
    k, b, cfg = SERVICE.topk, SERVICE.query_batch, svc.index.config
    q, w = svc.wl.batch(b, SEED + 100)  # the f32 path's first batch
    int8 = tapi.Index.build(SEED + 2, svc.wl.data, dataclasses.replace(cfg, storage="int8"))
    stream = tapi.Index.build(SEED + 2, svc.wl.data, cfg, update=tapi.UpdateSpec(
        delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD))
    for t in range(1, 13):  # the stream path's ticks 1-12, before its compact
        centres, rows = stream_rows(SEED + 1000 + t, STREAM_INGEST // CLUSTER, cfg.d)
        stream, _ = stream.insert(rows)
        stream = stream.delete(torch.arange((t - 1) * STREAM_RETIRE, t * STREAM_RETIRE,
                                            dtype=torch.int32, device="cuda"))
    sq, sw = stream_batch(svc.wl, centres, SEED + 2000 + 12)
    batches = {
        "f32 probe": (svc.index, q, w, tapi.QuerySpec(k=k)),
        "int8 screened": (int8, q, w, tapi.QuerySpec(k=k, screen_alpha=SCREEN_ALPHA)),
        "multiprobe": (svc.index, q, w, tapi.QuerySpec(k=k, mode="multiprobe", n_probes=8,
                                                       max_flips=3)),
        "exact": (svc.index, q, w, tapi.QuerySpec(k=k, mode="exact")),
        "stream tick 12": (stream, sq, sw, tapi.QuerySpec(k=k)),
        "streamed early exit": (svc.index, q, w, tapi.QuerySpec(
            k=k, early_exit=True, exit_group=EXIT_GROUP, exit_slack=EXIT_SLACK)),
    }
    print(f"  SERVICE batches (b={b}, n={svc.index.n}, d={cfg.d}; stream fill "
          f"{stream.delta_fill}), {card}:")
    out = {"audit_s": audit_s, "checked_against_cpu": n_cmp, "max_abs_err": worst,
           "paths": {row["name"]: {
        "tracker_peak_bytes": row["peak_live_bytes"],
        "allocator_peak_bytes": row.get("allocator_peak_bytes")} for row in report["paths"]}}
    out["service"] = {label: _batch_contracts(label, lambda a=args: a[0].query(*a[1:]))
                      for label, args in batches.items()}
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  static_contracts phase: {out['phase_s']:.1f} s (the audit {audit_s:.1f} s), {card}")
    return counts, out


# The lm path: LM serving with ALSH retrieval at the full width of gemma3-1b
# (serve --mode lm's defaults: 4 prompts of 64 tokens, 16 new tokens each;
# the retrieval attachment at RetrievalConfig()'s defaults)
LM_ARCH = "gemma3-1b"
LM_BATCH, LM_PROMPT, LM_GEN = 4, 64, 16
LM_GROW_CAP = 8192  # the growing datastore's delta (one extend_datastore a step)
LM_LOGIT_TOL = 1e-4  # f32 logits, card against the CPU (sums in another order)
LM_KNN_TOL = 1e-5  # kNN log-probs, card against the CPU plain path
LM_CONSISTENCY_TOL = 2e-2  # the reference's prefill/decode bar (tests/test_archs.py)
LM_CONSISTENCY_S = (512, 600)  # a multiple of the window and not (asserted, printed)
LM_REDUCED_STEPS = 4
LM_TIMING_LOOPS = 3  # decode loops a variant, interleaved; the median is reported
LM_HOST_REPS = 5  # single steps a variant timed for the host split; the median is reported
LM_NEAR_NOISE = 0.01  # near-duplicate keys: a datastore record + U(-0.01, 0.01) a coordinate


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    return [tree]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def _datastore_on_cpu(state):
    """A copy of a retrieval state on the CPU (its index leaf for leaf)."""
    import dataclasses

    from repro_torch.runtime.retrieval import RetrievalState

    idx = state.index
    cpu = dataclasses.replace(idx, state=idx.state.to("cpu"), delta=idx.delta.to("cpu"),
                              tombstones=idx.tombstones.cpu())
    return RetrievalState(index=cpu, values=state.values.cpu(), proj=state.proj.cpu(),
                          default_w=state.default_w.cpu())


def _lookup_against_cpu(label, state, rcfg, vocab, q):
    """The card's lookup and kNN log-probs on reduced keys ``q`` against the
    CPU plain path's over a copy of the same datastore: equal ids and
    ``n_candidates``, dists within DIST_RTOL/ATOL, log-probs within
    LM_KNN_TOL."""
    import torch

    from repro_torch.runtime import retrieval as rt

    cpu = _datastore_on_cpu(state)
    w = state.default_w.expand(q.shape)
    spec = rt.query_spec(rcfg)
    got = state.index.query(q, w, spec)
    want = cpu.index.query(q.cpu(), w.cpu(), spec)
    idx = cpu.index
    table = torch.cat([idx.state.data, idx.delta.data]) if idx.mutable else idx.state.data
    err = _against_cpu(label, got, want, table, q.cpu(), w.cpu())
    same_ids = bool(torch.equal(got.ids.cpu(), want.ids))
    lp = rt.knn_logprobs(q, state, rcfg, vocab).cpu()
    lp_err = float((lp - rt.knn_logprobs(q.cpu(), cpu, rcfg, vocab)).abs().max())
    print(f"  [lm] {label}: card vs the CPU plain path on {tuple(q.shape)} reduced keys: ids "
          f"equal {same_ids}, n_candidates equal, dists max_abs_err {err:.3g}, kNN log-probs "
          f"max_abs_err {lp_err:.3g} (tolerance {LM_KNN_TOL})")
    if not same_ids or lp_err > LM_KNN_TOL:
        raise AssertionError(f"{label}: the card's lookup disagrees with the CPU plain path")
    return {"dists_err": err, "logp_err": lp_err}


def _consistency_gap(params, cfg, S, seed):
    """Prefill S+1 tokens against prefill S then one decode step: the max
    |logits| gap (B=1, cache of S + 8 slots)."""
    import torch

    from repro_torch import models

    toks = torch.randint(0, cfg.vocab_size, (1, S + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(seed)).cuda()
    full, _ = models.forward_prefill(params, {"tokens": toks}, cfg)
    _, caches = models.forward_prefill(params, {"tokens": toks[:, :S]}, cfg, cache_len=S + 8)
    step = {"token": toks[:, S], "pos": torch.full((1,), S, dtype=torch.int32, device="cuda")}
    logits = models.forward_decode(params, step, caches, cfg)[0]
    return float((logits - full).abs().max())


def _count_aten_ops(fn):
    """ATen ops one call of ``fn`` dispatches (backward ops included)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    with Count() as count:
        fn()
    return count.n


def _host_split(label, fn):
    """Where one call's host time goes: the median wall of LM_HOST_REPS
    calls; the ATen ops it dispatches (counted under a TorchDispatchMode)
    and that wall over them; the caching allocator's allocations and new
    segments (cudaMalloc) a call; and, under torch.profiler, the self CPU
    time of ATen ops, of CUDA runtime calls, and the rest of the profiled
    wall (Python between the ops, and the profiler's own cost)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    walls = []
    for _ in range(LM_HOST_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    n_ops = _count_aten_ops(fn)
    stats0 = torch.cuda.memory_stats()
    fn()
    torch.cuda.synchronize()
    stats1 = torch.cuda.memory_stats()
    wall_ms = statistics.median(walls)
    out = {"wall_ms": wall_ms, "walls_ms": walls, "aten_ops": n_ops,
           "us_per_op": wall_ms * 1e3 / n_ops,
           "allocations": stats1["allocation.all.allocated"] - stats0["allocation.all.allocated"],
           "segments": stats1["segment.all.allocated"] - stats0["segment.all.allocated"]}
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            prof_us = (time.perf_counter() - t0) * 1e6
        rows = prof.key_averages()
        aten_us = sum(e.self_cpu_time_total for e in rows if e.key.startswith("aten::"))
        rt_us = sum(e.self_cpu_time_total for e in rows if e.key.startswith("cuda"))
        out["profiled"] = {"wall_us": prof_us, "aten_self_us": aten_us, "cuda_runtime_us": rt_us,
                           "rest_us": prof_us - aten_us - rt_us}
    except Exception as e:  # diagnostics only: a profiler fault must not fail the run
        out["profiled"] = f"not measured ({type(e).__name__}: {e})"
    p = out["profiled"]
    split = p if isinstance(p, str) else (
        f"profiled wall {p['wall_us']:.0f} us = ATen self {p['aten_self_us']:.0f} + CUDA runtime "
        f"{p['cuda_runtime_us']:.0f} + the rest (Python, the profiler) {p['rest_us']:.0f}")
    print(f"  [lm] host of {label}: median wall {wall_ms:.3f} ms of "
          f"{[round(x, 3) for x in walls]}; {n_ops} ATen ops, {out['us_per_op']:.1f} us of "
          f"wall an op; allocator {out['allocations']} allocations, {out['segments']} new "
          f"segments; {split}")
    return out


def _lm_scan_shape(run, calls, launches):
    """``wl1_scan_topk`` at the inputs the lm path's exact lookup gave it:
    against its plain version and bit for bit against ``wl1_scan`` and a
    stable sort, timed beside the plain version, with its bound."""
    import torch

    from repro_torch.kernels import ops

    if len(calls) != 1:
        raise AssertionError(f"the exact lookup made {len(calls)} scans, not 1")
    data, q, w, k = (calls[0][x] for x in ("data", "queries", "weights", "k"))
    (n, d), b = data.shape, q.shape[0]
    label = f"[lm] wl1_scan_topk at the exact lookup n={n} b={b} d={d} k={k}"
    got = ops.wl1_scan_topk(data, q, w, k)
    want = ops.wl1_scan_topk(data, q, w, k, force="plain")
    torch.cuda.synchronize()
    err = _check_topk(label, got, want, data, q, w)
    sd, si = sorted_scan_topk(data, q, w, k)
    if not (torch.equal(got[0], sd) and torch.equal(got[1], si)):
        raise AssertionError(f"{label}: differs from wl1_scan + stable sort")
    ms = time_ms(lambda: ops.wl1_scan_topk(data, q, w, k), iters=10, warmup=2)
    plain_ms = time_ms(lambda: ops.wl1_scan_topk(data, q, w, k, force="plain"), iters=1)
    dev_us = device_us_per_call(label, lambda: ops.wl1_scan_topk(data, q, w, k))
    nbytes = 4 * (n * d + 2 * b * d) + 8 * b * k
    b_ms, b_by = bound(nbytes, 3 * b * n * d)
    print(f"  {label}: bit-equal to wl1_scan + stable sort; kernel {ms:.4f} ms (device per "
          f"call {_fmt_us(dev_us)}), plain {plain_ms:.4f} ms, library: none; bound "
          f"{b_ms * 1e3:.2f} us by {b_by}; lm-path launches {launches}")
    numbers = {"n": n, "b": b, "d": d, "k": k, "ms": ms, "device_us": dev_us,
               "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
               "max_abs_err": err}
    run.kernels.setdefault("wl1_scan_topk", {})["lm_shape"] = numbers
    return numbers


def _lm_recall_by_keys(state, rcfg, q_dec):
    """recall@k of the probe lookups against exact mode on three kinds of
    keys of the decode-step batch's size: the decode steps' own, keys drawn
    like the datastore's (uniform), and near-duplicates of its records. For
    each: how often the exact nearest record is found, the spread of the
    keys (mean per-coordinate std; uniform's is 0.289) and how much nearer
    the exact k-th neighbour is than the median record (weighted L1)."""
    import torch

    from repro_torch.distance import recall_at_k
    from repro_torch.runtime import retrieval as rt

    data, w_row = state.index.state.data, state.default_w
    (n, d), b = data.shape, q_dec.shape[0]
    g = torch.Generator().manual_seed(SEED + 6)
    rows = torch.randint(0, n, (b,), generator=g).cuda()
    uniform = torch.rand((b, d), generator=g).cuda()
    noise = ((torch.rand((b, d), generator=g) * 2 - 1) * LM_NEAR_NOISE).cuda()
    keys = {"decode steps": q_dec, "uniform": uniform,
            "near-duplicates": (data[rows] + noise).clamp(0.0, 1.0)}
    out = {}
    for label, q in keys.items():
        w = w_row.expand(q.shape)
        probe = state.index.query(q, w, rt.query_spec(rcfg))
        exact = state.index.query(q, w, rt.QuerySpec(k=rcfg.topk, mode="exact"))
        median = torch.cdist(q * w_row, data * w_row, p=1).median(dim=1).values
        top1 = (probe.ids == exact.ids[:, :1]).any(dim=1).float().mean()
        out[label] = {"recall": recall_at_k(probe.ids, exact.ids, rcfg.topk),
                      "top1_found": float(top1),
                      "cand_per_query": float(probe.n_candidates.float().mean()),
                      "key_std": float(q.std(dim=0).mean()),
                      "kth_over_median": float((exact.dists[:, -1] / median).mean()),
                      "first_over_median": float((exact.dists[:, 0] / median).mean())}
        r = out[label]
        print(f"  [lm] recall@{rcfg.topk} on {b} {label} keys: {r['recall']:.4f}; exact nearest "
              f"found {r['top1_found']:.3f}; {r['cand_per_query']:.1f} candidates a query; key "
              f"std {r['key_std']:.4f}; exact 1st / {rcfg.topk}th neighbour over the median "
              f"record {r['first_over_median']:.4f} / {r['kth_over_median']:.4f}")
    return out


def phase_lm_path(run, card):
    """LM serving with ALSH retrieval (``serve --mode lm``'s flow) at the full
    width of gemma3-1b (26 layers, d_model 1152, 4 heads over 1 kv head x
    256, d_ff 6912, vocab 262,144; f32 parameters drawn on the card from a
    seed, bf16 compute):

    1. two datastores from one seed at ``RetrievalConfig()``'s defaults
       (65,536 records, d_key 64, M=32, theta, K=8, L=16, C=64, top 8): a
       sealed one and a growing one (``delta_capacity=8192``);
    2. with the launch counts zeroed: the prefill of 4 random prompts of 64
       tokens (cold and warm), then 16 greedy decode steps three ways from
       its caches, three loops of each, interleaved (the median loop's ms
       a step is reported) — plain, with retrieval (``make_decode_step(cfg,
       rcfg)``), and growing (the same step over the growing datastore,
       returning its hidden state, then ``extend_datastore`` with it and
       the step's tokens) —, each step's launches (retrieval: one
       ``alsh_project`` and one ``gather_rerank_topk``; growing: two
       projections, the query's and the insert's, and one two-segment
       gather), one step of each profiled (device busy, idle share), its
       host time split (``_host_split``) and run under the audit's tracker
       (peak bytes, host syncs per step by line), and recall@8 of the last
       growing loop's 64 reduced keys on the sealed datastore against its
       exact mode (``wl1_scan_topk``);
    3. after the counts are read: that exact lookup against the CPU plain
       path, and its scan at the captured shape against the plain version
       (``_lm_scan_shape``); recall on uniform and near-duplicate keys
       beside the decode steps' (``_lm_recall_by_keys``); the lookups of
       the last steps on both datastores against the CPU plain path over
       copies of them (ids equal, dists 1e-5, kNN log-probs 1e-5), and the
       kernels at the path's captured shapes against their plain versions
       with their times and bounds (``_kernel_shapes``); the casts of one
       decode step replayed alone;
    4. the reduced gemma3-1b in f32 on the card and the CPU with the same
       parameters: prefill and 4 decode steps, logits within 1e-4, tokens
       equal;
    5. the full width at f32 compute: prefill(S + 1) against prefill(S) and
       one decode step, at S=512 (within the reference's 2e-2) and S=600,
       whose gap is the reference's ring-buffer behaviour (ROADMAP.md
       Queue C item 2), printed and not asserted."""
    import dataclasses

    import torch

    from repro_torch import models
    from repro_torch.configs import RetrievalConfig, get_bundle, reduced_model
    from repro_torch.distance import recall_at_k
    from repro_torch.kernels import _build
    from repro_torch.runtime import retrieval as rt
    from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step

    t_phase = time.perf_counter()
    cfg = get_bundle(LM_ARCH).model
    B, S, G, V = LM_BATCH, LM_PROMPT, LM_GEN, cfg.vocab_size
    out = {"card": card}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = models.init_params(SEED, cfg, device="cuda")
    torch.cuda.synchronize()
    leaves = _tree_leaves(params)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    out.update(n_params=n_params, param_bytes=param_bytes,
               init_s=time.perf_counter() - t0)
    print(f"  [lm] {cfg.name}: {cfg.n_layers} layers ({cfg.scan_unit} x {cfg.resolved_units} + "
          f"{cfg.tail}), d_model {cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} kv x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {V}: {n_params} parameters, {param_bytes} B "
          f"({cfg.param_dtype}; compute {cfg.compute_dtype}), drawn on the card in "
          f"{out['init_s']:.2f} s")

    # 1. the datastores
    rcfg = RetrievalConfig()
    gcfg = dataclasses.replace(rcfg, delta_capacity=LM_GROW_CAP)
    built = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    build_calls = _capture_kernel_calls(lambda: built.append(
        rt.build_datastore(SEED + 1, cfg.d_model, V, rcfg, device="cuda")))
    torch.cuda.synchronize()
    out["datastore_build_s"] = time.perf_counter() - t0
    sealed = built[0]
    grow0 = rt.build_datastore(SEED + 1, cfg.d_model, V, gcfg, device="cuda")
    if not torch.equal(grow0.index.state.sorted_keys, sealed.index.state.sorted_keys):
        raise AssertionError("the growing datastore's main segment differs from the sealed one")
    icfg = sealed.index.config
    print(f"  [lm] datastores: n={sealed.index.n} d_key={icfg.d} M={icfg.M} {icfg.family} "
          f"K={icfg.K} L={icfg.L} C={icfg.max_candidates} top {rcfg.topk}, sealed and with a "
          f"delta of {LM_GROW_CAP}; the sealed one built in {out['datastore_build_s']:.3f} s "
          f"(with the spy on its projection call)")

    # 2. the served path, launch counts zeroed
    prompt = torch.randint(0, V, (B, S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(SEED + 3)).cuda()
    prefill = make_prefill_step(cfg, cache_len=S + G)
    plain = make_decode_step(cfg)
    retr = make_decode_step(cfg, rcfg)
    grow = make_decode_step(cfg, gcfg, return_hidden=True)

    def grow_step(batch, caches, state):
        mixed, tok, new_caches, hidden = grow(params, batch, caches, state)
        state, ids = rt.extend_datastore(state, hidden, tok)
        return mixed, tok, new_caches, state, hidden, ids

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    prefill_ms = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, {"tokens": prompt})
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != (B, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite (B, V)")
    out["prefill_ms"] = {"cold": prefill_ms[0], "warm": prefill_ms[1]}
    print(f"  [lm] prefill B={B} S={S}: cold {prefill_ms[0]:.2f} ms, warm {prefill_ms[1]:.2f} ms")

    def batch_at(i, tok):
        return {"token": tok, "pos": torch.full((B,), S + i, dtype=torch.int32, device="cuda")}

    def decode_loop(name):
        """G greedy steps of one variant from the prefill's caches (the
        growing one from the empty delta)."""
        before = _build.launch_counts()
        tok, c, toks, st, hidden, ids = tok0, caches, [tok0], grow0, [], None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(G):
            if name == "plain":
                mixed, tok, c = plain(params, batch_at(i, tok), c)
            elif name == "retrieval":
                mixed, tok, c = retr(params, batch_at(i, tok), c, sealed)
            else:
                mixed, tok, c, st, h, ids = grow_step(batch_at(i, tok), c, st)
                hidden.append(h)
            toks.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / G
        after = _build.launch_counts()
        toks = torch.stack(toks, dim=1).cpu()
        if not bool(torch.isfinite(mixed).all()) or not bool(((toks >= 0) & (toks < V)).all()):
            raise AssertionError(f"{name} decode: non-finite output or a token out of range")
        return {"ms": ms, "toks": toks, "state": st, "hidden": hidden, "ids": ids,
                "launches": {k: (after[k] - before[k]) / G for k in after if after[k] != before[k]}}

    names = ("plain", "retrieval", "growing")
    loops = {name: [] for name in names}
    for _ in range(LM_TIMING_LOOPS):  # the variants interleaved, loop by loop
        for name in names:
            loops[name].append(decode_loop(name))
    steps = {}
    for name in names:
        first, ms_all = loops[name][0], [r["ms"] for r in loops[name]]
        if any(r["launches"] != first["launches"] for r in loops[name]):
            raise AssertionError(f"{name} decode: the loops launched differently")
        steps[name] = {"ms_per_step": statistics.median(ms_all), "ms_per_step_loops": ms_all,
                       "launches_per_step": first["launches"],
                       "first_tokens": first["toks"][0, :8].tolist()}
        print(f"  [lm] decode {name}: {LM_TIMING_LOOPS} loops of {G} steps x {B} seqs, median "
              f"{steps[name]['ms_per_step']:.3f} ms/step (loops {[round(x, 3) for x in ms_all]}); "
              f"launches per step {first['launches']}; first tokens (seq 0) "
              f"{steps[name]['first_tokens']}")
    want = {"retrieval": {"alsh_project": 1, "gather_rerank_topk": 1},
            "growing": {"alsh_project": 2, "gather_rerank_topk_two_seg": 1}}
    for name, need in want.items():
        if steps[name]["launches_per_step"] != need:
            raise AssertionError(f"{name} decode launched {steps[name]['launches_per_step']} "
                                 f"per step, not {need}")
    if steps["plain"]["launches_per_step"]:
        raise AssertionError("the plain decode launched a kernel")
    last = loops["growing"][-1]
    state, grow_hidden = last["state"], last["hidden"]
    if state.index.delta_fill != B * G or not bool((last["ids"] >= 0).all()):
        raise AssertionError(f"growing datastore: fill {state.index.delta_fill}, not {B * G}")
    out["steps"] = steps
    print(f"  [lm] growing datastore: delta fill {state.index.delta_fill} of {LM_GROW_CAP}")

    # one step of each: device busy and idle share, where the host time goes,
    # peak bytes, host syncs
    one = {
        "plain": lambda: plain(params, batch_at(0, tok0), caches),
        "retrieval": lambda: retr(params, batch_at(0, tok0), caches, sealed),
        "growing": lambda: grow_step(batch_at(0, tok0), caches, grow0),
    }
    for name, fn in one.items():
        busy = profile(f"of one {name} decode step", fn, unprofiled_wall=True)
        steps[name]["device_busy_us"] = busy
        steps[name]["host"] = _host_split(f"one {name} decode step", fn)
        steps[name].update(_batch_contracts(f"lm {name} step", fn))

    # recall@8 of the growing steps' reduced keys on the sealed datastore;
    # the exact lookup's scan is captured for its check after the counts
    exact_spec = rt.QuerySpec(k=rcfg.topk, mode="exact")
    q_all = rt.reduce_key(torch.cat(grow_hidden), sealed)
    w_all = sealed.default_w.expand(q_all.shape)
    probe = sealed.index.query(q_all, w_all, rt.query_spec(rcfg))
    exacts = []
    scan_calls = _capture_kernel_calls(
        lambda: exacts.append(sealed.index.query(q_all, w_all, exact_spec)),
        names=("wl1_scan_topk",))["wl1_scan_topk"]
    exact = exacts[0]
    out["recall_at_8"] = recall_at_k(probe.ids, exact.ids, rcfg.topk)
    out["cand_per_query"] = float(probe.n_candidates.float().mean())
    print(f"  [lm] recall@{rcfg.topk} of the probe lookups against exact mode on "
          f"{q_all.shape[0]} decode-step keys: {out['recall_at_8']:.3f} "
          f"({out['cand_per_query']:.1f} candidates a query)")
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    counts = _path_counts("lm", ("alsh_project", "gather_rerank_topk",
                                 "gather_rerank_topk_two_seg", "wl1_scan_topk"))
    print(f"  [lm] allocator peak over the path {out['peak_allocated_bytes']} B "
          f"({out['peak_allocated_bytes'] / 2**30:.2f} GiB)")

    # the exact lookup against the CPU plain path, and its scan at the path's
    # shape against the plain version; then recall on other keys
    cpu = _datastore_on_cpu(sealed)
    want_exact = cpu.index.query(q_all.cpu(), w_all.cpu(), exact_spec)
    out["exact_against_cpu"] = _against_cpu("[lm] exact lookup, all steps: card vs the CPU "
                                            "plain path", exact, want_exact,
                                            cpu.index.state.data, q_all.cpu(), w_all.cpu())
    print(f"  [lm] exact lookup of the {q_all.shape[0]} decode-step keys: card vs the CPU plain "
          f"path, dists max_abs_err {out['exact_against_cpu']:.3g}, ids equal "
          f"{bool(torch.equal(exact.ids.cpu(), want_exact.ids))}")
    del cpu, want_exact
    out["scan"] = _lm_scan_shape(run, scan_calls, counts["wl1_scan_topk"])
    out["recall_by_keys"] = _lm_recall_by_keys(sealed, rcfg, q_all)

    # 3. the lookups and the kernels against their plain versions
    q_last = q_all[-B:]
    out["against_cpu"] = {
        "sealed": _lookup_against_cpu("sealed lookup", sealed, rcfg, V, q_last),
        "growing": _lookup_against_cpu("growing lookup (fill 64)", state, gcfg, V, q_last),
        "sealed, 64 keys": _lookup_against_cpu("sealed lookup, all steps", sealed, rcfg, V,
                                               q_all),
    }
    sealed_calls = _capture_kernel_calls(lambda: retr(params, batch_at(0, tok0), caches, sealed))
    grow_calls = _capture_kernel_calls(lambda: grow_step(batch_at(0, tok0), caches, state))
    if len(grow_calls["alsh_project"]) != 2:
        raise AssertionError("the growing step made other than two projections")
    calls = {
        f"datastore build n={sealed.index.n}, unweighted": build_calls,
        f"decode step b={B}, sealed": sealed_calls,
        f"decode step b={B}, growing (fill {state.index.delta_fill})": {
            "alsh_project": grow_calls["alsh_project"][:1],
            "gather_rerank_topk": grow_calls["gather_rerank_topk"]},
        f"insert b={B}, unweighted": {"alsh_project": grow_calls["alsh_project"][1:],
                                      "gather_rerank_topk": []},
    }
    out["kernel_shapes"] = _kernel_shapes(run, "lm", calls, counts, two_seg=True)

    # the casts one decode step makes (f32 weights to bf16 per call, the
    # table cast for the lookup and for the tied unembedding, and its upcast)
    cdt = getattr(torch, cfg.compute_dtype)
    table = params["embed"]["table"]
    weights = [t for t in leaves if t.ndim >= 2 and t is not table]

    def casts():
        for t in weights:
            t.to(cdt)
        table.to(cdt)
        table.to(cdt).float()

    cast_ms = time_ms(casts, iters=5, warmup=1)
    w_elems = sum(t.numel() for t in weights)
    cast_bytes = 6 * w_elems + 6 * table.numel() + 12 * table.numel()
    out["casts"] = {"ms": cast_ms, "bytes": cast_bytes,
                    "bound_ms": cast_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"  [lm] the casts of one decode step alone: {cast_ms:.3f} ms for {cast_bytes} B "
          f"(bound {out['casts']['bound_ms']:.3f} ms at 3.35 TB/s); the products then read the "
          f"cast weights and the upcast table ({2 * w_elems + 4 * table.numel()} B)")

    # 4. the reduced model, card against the CPU
    red = reduced_model(cfg)
    if red.compute_dtype != "float32":
        raise AssertionError("the reduced config computes in f32")
    p_cpu = models.init_params(SEED, red, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    rprompt = torch.randint(0, red.vocab_size, (B, S), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(SEED + 4))
    worst = 0.0
    lc, cc = models.forward_prefill(p_cpu, {"tokens": rprompt}, red, cache_len=S + 8)
    lg, cg = models.forward_prefill(p_gpu, {"tokens": rprompt.cuda()}, red, cache_len=S + 8)
    tc, tg = (torch.argmax(x, -1).to(torch.int32) for x in (lc, lg))
    for i in range(LM_REDUCED_STEPS + 1):
        worst = max(worst, float((lg.cpu() - lc).abs().max()))
        if not torch.equal(tg.cpu(), tc) or worst > LM_LOGIT_TOL:
            raise AssertionError(f"reduced {red.name}: card and CPU disagree at step {i} "
                                 f"(logits {worst:.3g})")
        if i == LM_REDUCED_STEPS:
            break
        pos = torch.full((B,), S + i, dtype=torch.int32)
        lc, tc, cc = models.forward_decode(p_cpu, {"token": tc, "pos": pos}, cc, red)
        lg, tg, cg = models.forward_decode(p_gpu, {"token": tg, "pos": pos.cuda()}, cg, red)
    out["reduced_card_vs_cpu"] = worst
    print(f"  [lm] reduced {red.name} (f32) on the card and the CPU, same parameters: prefill "
          f"and {LM_REDUCED_STEPS} decode steps, logits max_abs_err {worst:.3g} (tolerance "
          f"{LM_LOGIT_TOL}), tokens equal")

    # 5. full-width consistency at f32 compute
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    gaps = {}
    for S_c in LM_CONSISTENCY_S:
        gaps[S_c] = _consistency_gap(params, cfg32, S_c, SEED + 5)
        print(f"  [lm] prefill({S_c + 1}) against prefill({S_c}) + one decode step, f32 "
              f"compute, window {cfg.window}: max |logit gap| {gaps[S_c]:.3g}"
              + (f" (bar {LM_CONSISTENCY_TOL})" if S_c % cfg.window == 0 else
                 " (printed: the reference's ring-buffer write, ROADMAP.md Queue C item 2)"))
    if gaps[LM_CONSISTENCY_S[0]] > LM_CONSISTENCY_TOL:
        raise AssertionError(f"full-width prefill/decode gap {gaps[LM_CONSISTENCY_S[0]]:.3g}")
    out["consistency_gap"] = gaps
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [lm] phase {out['phase_s']:.1f} s, {card}")
    print(f"  [lm] numbers: {json.dumps(out, default=str)}")
    return counts, out


TRAIN_ARCH = "gemma3-1b"  # the lm path's config, uncut
TRAIN_SHAPE = "train_4k"  # its sequence length; the batch is cut
TRAIN_BATCH = 2  # of train_4k's 256 (one card)
TRAIN_PEAK_LIMIT = 72e9  # allocator bytes past which the batch drops to 1
TRAIN_TIMED_STEPS = 5
TRAIN_COMPRESSED_STEPS = 2  # microbatch=2, int8_ef, after one warm-up step of its own
TRAIN_F32_LOSS_RTOL = 1e-5  # card vs CPU, f32 compute: the same sums in other orders
TRAIN_F32_GRAD_TOL = 1e-5  # of each gradient leaf's largest |entry|
TRAIN_BF16_LOSS_TOL = 2e-3  # bf16 compute: cuBLAS and the CPU round bf16 at other points
TRAIN_BF16_GRAD_L2 = 0.05  # relative L2 error over the whole gradient tree
TRAIN_UPDATE_L2 = 1e-3  # f32: one step's parameter update, relative L2 error over the tree
# (not a max: Adam's first step is ~lr * g / |g|, so an entry with |g| near eps
# can move by any part of 2 lr for a last-bit difference in g)
TRAIN_MOMENT_TOL = 1e-4  # f32: moments within 1e-4 of each leaf's largest |entry|
TRAIN_PIPE_FWD = dict(rtol=1e-5, atol=1e-5)  # tests/test_pipeline.py's bar
TRAIN_PIPE_GRAD = dict(rtol=1e-4, atol=1e-5)
TRAIN_DRILL_STEPS, TRAIN_DRILL_FAIL, TRAIN_DRILL_EVERY = 10, 7, 5
DRILL_TIMEOUT_S = 600


def _named(tree):
    from repro_torch.runtime.train_step import named_leaves

    return dict(named_leaves(tree))


def _timed_train_steps(step_fn, state, stream, first: int, n: int):
    """``n`` steps from ``state`` on the stream's batches ``first…``: each
    step's host-clock ms, from the batch on the card to the sync on its
    loss; returns (state, ms list, last metrics as floats)."""
    import torch

    ms, metrics = [], None
    for i in range(n):
        batch = {k: torch.as_tensor(v).cuda() for k, v in stream.batch(first + i).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        metrics = {k: float(v) for k, v in m.items()}  # the sync on the loss ends the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return state, ms, metrics


def _train_full_width(cfg, tcfg, S, out):
    """(a): the full-width steps at batch TRAIN_BATCH (1 when the allocator
    peak passes TRAIN_PEAK_LIMIT or the card runs out of memory)."""
    import dataclasses

    import torch

    from repro_torch import optim
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.runtime import train_step as ts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = ts.init_train_state(SEED, cfg, tcfg, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in ts.tree_leaves(state.params))
    state_bytes = sum(t.numel() * t.element_size() for t in ts.train_state_leaves(state).values())
    out.update(n_params=n_params, state_bytes=state_bytes, init_s=time.perf_counter() - t0)
    print(f"  [train] {cfg.name}: {n_params} parameters ({cfg.param_dtype}; compute "
          f"{cfg.compute_dtype}, remat={cfg.remat} {cfg.remat_policy!r}, loss_chunk "
          f"{cfg.loss_chunk}); state {state_bytes} B with f32 moments, drawn on the card in "
          f"{out['init_s']:.2f} s")
    del state
    step_fn = ts.make_train_step(cfg, tcfg)

    def attempt(B):
        """A warm-up step and the timed ones at batch B, from the seed's state."""
        stream = SyntheticStream(DataConfig(seq_len=S, global_batch=B, seed=SEED), cfg)
        torch.cuda.reset_peak_memory_stats()
        state = ts.init_train_state(SEED, cfg, tcfg, device="cuda")
        state, warm_ms, first = _timed_train_steps(step_fn, state, stream, 0, 1)
        if torch.cuda.max_memory_allocated() > TRAIN_PEAK_LIMIT:
            raise MemoryError(f"batch {B} peaked at {torch.cuda.max_memory_allocated()} B, past "
                              f"{TRAIN_PEAK_LIMIT:.0f}")
        state, ms, metrics = _timed_train_steps(step_fn, state, stream, 1, TRAIN_TIMED_STEPS)
        return B, stream, state, warm_ms[0], ms, metrics, first

    why, result = None, None
    try:
        result = attempt(TRAIN_BATCH)
    except (torch.cuda.OutOfMemoryError, MemoryError) as e:
        why = f"batch {TRAIN_BATCH} does not fit: {type(e).__name__}: {str(e)[:300]}"
    if result is None:  # retried outside the handler, whose traceback holds the tensors
        print(f"  [train] {why}; batch 1")
        gc.collect()
        torch.cuda.empty_cache()
        result = attempt(1)
    B, stream, state, warm_ms, ms, metrics, first = result
    peak = torch.cuda.max_memory_allocated()
    out.update(batch=B, seq_len=S, batch_cut_reason=why, warmup_ms=warm_ms)
    med = statistics.median(ms)
    out.update(ms_per_step=med, ms_steps=ms, tokens_per_s=B * S / (med / 1e3),
               peak_allocated_bytes=peak, loss=metrics["loss"], grad_norm=metrics["grad_norm"],
               lr=metrics["lr"], first_loss=first["loss"], first_grad_norm=first["grad_norm"],
               ln_vocab=math.log(cfg.vocab_size))
    if not all(math.isfinite(m[k]) for m in (first, metrics) for k in ("loss", "grad_norm")):
        raise AssertionError(f"full-width train steps: first {first}, last {metrics}")
    print(f"  [train] B={B} S={S} ({B * S} tokens a step): warm-up {warm_ms:.1f} ms, then "
          f"{TRAIN_TIMED_STEPS} steps median {med:.1f} ms/step ({[round(x, 1) for x in ms]}), "
          f"{out['tokens_per_s']:.0f} tokens/s; loss {first['loss']:.4f} at the first step (ln V "
          f"= {out['ln_vocab']:.2f}; grad norm {first['grad_norm']:.4f}), {metrics['loss']:.4f} "
          f"at step {TRAIN_TIMED_STEPS + 1} (grad norm {metrics['grad_norm']:.4f}, lr "
          f"{metrics['lr']:.3g}); allocator peak {peak} B ({peak / 2**30:.2f} GiB)")

    batch = {k: torch.as_tensor(v).cuda() for k, v in stream.batch(TRAIN_TIMED_STEPS + 1).items()}
    prof = {}
    profile("of one full-width train step", lambda: step_fn(state, batch), top=15,
            unprofiled_wall=True, into=prof)
    out["profile"] = prof
    out["aten_ops_per_step"] = _count_aten_ops(lambda: step_fn(state, batch))
    print(f"  [train] one step dispatches {out['aten_ops_per_step']} ATen ops")

    _, grads = ts._value_and_grad(state.params, batch, cfg)
    adam_ms = time_ms(lambda: optim.adamw_update(state.params, grads, state.opt, tcfg), iters=3)
    adam_bytes = 28 * n_params  # read p, g, m, v; write p, m, v (f32)
    out["adamw"] = {"ms": adam_ms, "bytes": adam_bytes,
                    "bound_ms": adam_bytes / HBM_BYTES_PER_S * 1e3}
    print(f"  [train] adamw_update alone over {n_params} parameters: {adam_ms:.2f} ms (bound "
          f"{out['adamw']['bound_ms']:.2f} ms: {adam_bytes} B at 3.35 TB/s)")
    del grads

    ctcfg = dataclasses.replace(tcfg, microbatch=2, grad_compression="int8_ef")
    cstate = ts.TrainState(params=state.params, opt=optim.init_opt_state(state.params, ctcfg))
    del state
    cstep = ts.make_train_step(cfg, ctcfg)
    cstate, cwarm, _ = _timed_train_steps(cstep, cstate, stream, 0, 1)
    cstate, cms, cm = _timed_train_steps(cstep, cstate, stream, 1, TRAIN_COMPRESSED_STEPS)
    if not all(math.isfinite(v) for v in cm.values()):
        raise AssertionError(f"microbatch 2, int8_ef: metrics {cm}")
    out["compressed"] = {"warmup_ms": cwarm[0], "ms_steps": cms, "loss": cm["loss"],
                         "grad_norm": cm["grad_norm"]}
    print(f"  [train] microbatch 2, int8_ef: warm-up {cwarm[0]:.1f} ms, steps "
          f"{[round(x, 1) for x in cms]} ms; loss {cm['loss']:.4f}, grad norm "
          f"{cm['grad_norm']:.4f}")


def _train_card_vs_cpu(cfg):
    """(b): the reduced config, f32 compute and bf16 compute with remat, the
    same parameters on the card and the CPU: the loss and the gradients of
    ``forward_train``, and one ``make_train_step``'s metrics and state."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import TrainConfig, reduced_model
    from repro_torch.runtime import train_step as ts

    red = reduced_model(cfg)
    tcfg = TrainConfig(warmup_steps=2, total_steps=20)
    state = ts.init_train_state(SEED, red, tcfg, device="cpu")
    toks = torch.randint(0, red.vocab_size, (4, 64), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(SEED + 9))
    out = {}
    for compute, remat in (("float32", False), ("bfloat16", True)):
        c = dataclasses.replace(red, compute_dtype=compute, remat=remat)
        gpu_state = ts.train_state_from_leaves(ts.train_state_leaves(state), state, "cuda")
        lc, gc = ts._value_and_grad(state.params, {"tokens": toks}, c)
        lg, gg = ts._value_and_grad(gpu_state.params, {"tokens": toks.cuda()}, c)
        want = {k: v.double().numpy() for k, v in _named(gc).items()}
        got = {k: v.double().cpu().numpy() for k, v in _named(gg).items()}
        loss_err = abs(float(lg) - float(lc))
        grad_err = max(float(np.max(np.abs(got[k] - want[k]))) / max(
            float(np.max(np.abs(want[k]))), 1e-30) for k in want)
        grad_l2 = math.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
                            / sum(float(np.sum(want[k] ** 2)) for k in want))
        sc, mc = ts.make_train_step(c, tcfg)(state, {"tokens": toks})
        sg, mg = ts.make_train_step(c, tcfg)(gpu_state, {"tokens": toks.cuda()})
        lr = float(mc["lr"])
        before = {k: v.double().numpy() for k, v in ts.train_state_leaves(state).items()}
        want_s = {k: v.double().numpy() for k, v in ts.train_state_leaves(sc).items()}
        got_s = {k: v.double().cpu().numpy() for k, v in ts.train_state_leaves(sg).items()}
        params = [k for k in want_s if k.startswith("params/")]
        param_err = max(float(np.max(np.abs(got_s[k] - want_s[k]))) for k in params)
        update_l2 = math.sqrt(sum(float(np.sum((got_s[k] - want_s[k]) ** 2)) for k in params)
                              / sum(float(np.sum((want_s[k] - before[k]) ** 2)) for k in params))
        moment_err = max(float(np.max(np.abs(got_s[k] - want_s[k]))) / max(
            float(np.max(np.abs(want_s[k]))), 1e-30)
            for k in want_s if k.startswith(("opt/m/", "opt/v/")))
        r = {"loss_cpu": float(lc), "loss_err": loss_err, "grad_err_of_leaf_max": grad_err,
             "grad_rel_l2": grad_l2, "param_err": param_err, "param_err_over_lr": param_err / lr,
             "update_rel_l2": update_l2, "moment_err_of_leaf_max": moment_err,
             "step_metrics_err": {k: abs(float(mg[k]) - float(mc[k])) for k in mc}}
        out[compute] = r
        print(f"  [train] reduced {red.name} {compute} compute (remat {remat}), card vs CPU: "
              f"loss {float(lc):.6f} off by {loss_err:.3g}; grads off by {grad_err:.3g} of a "
              f"leaf's largest (rel L2 {grad_l2:.3g}); after one step the update off by "
              f"{update_l2:.3g} (rel L2; largest entry {param_err / lr:.3g} of the lr), moments "
              f"{moment_err:.3g} of a leaf's largest")
        if compute == "float32":
            bad = (loss_err > TRAIN_F32_LOSS_RTOL * abs(float(lc)) or grad_err > TRAIN_F32_GRAD_TOL
                   or update_l2 > TRAIN_UPDATE_L2 or moment_err > TRAIN_MOMENT_TOL)
        else:
            bad = loss_err > TRAIN_BF16_LOSS_TOL or grad_l2 > TRAIN_BF16_GRAD_L2
        if bad:
            raise AssertionError(f"reduced {compute}: card and CPU disagree: {r}")
    return out


def restart_drill() -> dict:
    """(c), in a process of its own (``--restart-drill``) under
    ``torch.use_deterministic_algorithms(True)``: on the card, the reduced
    bundle of tests/test_fault.py run clean for 10 steps and again with a
    failure injected at step 7, async checkpoints, restarted from the step-5
    commit: the two final states equal bit for bit; the committed step 10
    restored on the CPU equals the card's state leaf for leaf."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import get_bundle, reduced_model
    from repro_torch.data import DataConfig
    from repro_torch.runtime import fault
    from repro_torch.runtime import train_step as ts

    bundle = get_bundle(TRAIN_ARCH)
    mcfg = dataclasses.replace(reduced_model(bundle.model), n_units=1, n_layers=8,
                               tail=("local", "local"))
    tcfg = dataclasses.replace(bundle.train, total_steps=20, warmup_steps=2)
    bundle = dataclasses.replace(bundle, model=mcfg, train=tcfg)
    dcfg = DataConfig(seq_len=32, global_batch=2)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        clean = fault.train_loop(bundle, dcfg, TRAIN_DRILL_STEPS, f"{d}/clean",
                                 ckpt_every=TRAIN_DRILL_EVERY, device="cuda")
        clean_s = time.perf_counter() - t0
        faulty = fault.run_with_restarts(bundle, dcfg, TRAIN_DRILL_STEPS, f"{d}/faulty",
                                         failures=(TRAIN_DRILL_FAIL,),
                                         ckpt_every=TRAIN_DRILL_EVERY, async_ckpt=True,
                                         device="cuda")
        a, b = ts.train_state_leaves(clean), ts.train_state_leaves(faulty)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        template = ts.init_train_state(0, mcfg, tcfg, device="cpu")
        restored = fault.restore_train_state(f"{d}/faulty", TRAIN_DRILL_STEPS, template)
        r = ts.train_state_leaves(restored)
        cpu_differ = [k for k in b if not torch.equal(b[k].cpu(), r[k])]
    return {"leaves": len(a), "differ": differ, "cpu_restore_differ": cpu_differ,
            "clean_s": clean_s, "deterministic": torch.are_deterministic_algorithms_enabled()}


def _train_restart_drill():
    """Run ``restart_drill`` in a subprocess (its deterministic settings stay
    there) and check its answer."""
    import os

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--restart-drill"],
                         capture_output=True, text=True, env=env, timeout=DRILL_TIMEOUT_S)
    if res.returncode != 0:
        raise AssertionError(f"the restart drill failed:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-4000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    print(f"  [train] restart drill (deterministic, its own process, {out['process_s']:.1f} s): "
          f"{TRAIN_DRILL_STEPS} steps clean ({out['clean_s']:.1f} s) against a failure at step "
          f"{TRAIN_DRILL_FAIL} and a restart from the step-{TRAIN_DRILL_EVERY} commit, async "
          f"checkpoints: {out['leaves']} leaves, {len(out['differ'])} differ; the step-"
          f"{TRAIN_DRILL_STEPS} commit restored on the CPU: {len(out['cpu_restore_differ'])} "
          f"differ")
    if out["differ"] or out["cpu_restore_differ"] or not out["deterministic"]:
        raise AssertionError(f"restart drill: {out}")
    return out


def _train_pipeline():
    """(d): ``pipeline_apply`` over 4 stages on the one card against the
    sequential composition (tests/test_pipeline.py's shapes and bar)."""
    import numpy as np
    import torch

    from repro_torch.core.distributed import make_mesh
    from repro_torch.runtime.pipeline import pipeline_apply, pipeline_loss

    n_stages, n_micro, mb, dim = 4, 8, 2, 16
    rs = np.random.default_rng(SEED + 10)
    p = {"W": torch.tensor(rs.normal(size=(n_stages, dim, dim)).astype(np.float32) / dim ** 0.5,
                           device="cuda", requires_grad=True),
         "b": torch.tensor(rs.normal(size=(n_stages, dim)).astype(np.float32) * 0.1,
                           device="cuda", requires_grad=True)}
    x, tgt = (torch.tensor(rs.normal(size=(n_micro, mb, dim)).astype(np.float32), device="cuda")
              for _ in range(2))

    def stage(q, h):
        return torch.tanh(h @ q["W"] + q["b"])

    def loss_fn(y, t):
        return torch.mean((y - t) ** 2)

    def seq(xm):
        h = xm
        for s in range(n_stages):
            h = stage({k: v[s] for k, v in p.items()}, h)
        return h

    mesh = make_mesh((n_stages,), ("pod",), devices=["cuda"] * n_stages)
    y = pipeline_apply(stage, p, x, mesh)
    y_ref = torch.stack([seq(x[m]) for m in range(n_micro)])
    fwd_err = float((y - y_ref).detach().abs().max())
    torch.testing.assert_close(y, y_ref, **TRAIN_PIPE_FWD)
    g = torch.autograd.grad(pipeline_loss(stage, loss_fn, p, x, tgt, mesh), list(p.values()))
    g_ref = torch.autograd.grad(torch.mean(torch.stack([loss_fn(seq(x[m]), tgt[m])
                                                         for m in range(n_micro)])),
                                list(p.values()))
    grad_err = max(float((a - b).abs().max()) for a, b in zip(g, g_ref))
    for a, b in zip(g, g_ref):
        torch.testing.assert_close(a, b, **TRAIN_PIPE_GRAD)
    print(f"  [train] pipeline_apply, {n_stages} stages on one card, {n_micro} microbatches: "
          f"forward off by {fwd_err:.3g}, grads by {grad_err:.3g} from the sequential stages")
    return {"fwd_err": fwd_err, "grad_err": grad_err}


def phase_train_path(run, card):
    """Training (``launch/train``'s flow) at the full width of gemma3-1b (26
    layers, d_model 1152, vocab 262,144, f32 parameters drawn on the card,
    bf16 compute, ``remat=True``) under ``TrainConfig()``, at train_4k's
    S=4096 and batch TRAIN_BATCH (cut from 256):

    a. one warm-up step and TRAIN_TIMED_STEPS timed ones (ms per step, the
       median on the host clock to the sync on the loss; tokens/s), one
       step profiled (device busy, idle share, the top device ops) and its
       ATen ops counted, the allocator peak, ``adamw_update`` alone, loss
       and grad norm finite (the loss beside ln V); then
       TRAIN_COMPRESSED_STEPS steps with ``microbatch=2, int8_ef``;
    b. the reduced config on the card against the CPU (``_train_card_vs_cpu``);
    c. the deterministic restart drill in its own process (``restart_drill``);
    d. ``pipeline_apply`` over 4 stages on the card (``_train_pipeline``).

    No kernel of the port runs on this path: its launch counts, zeroed
    before (a) and read after (d), must all be 0. No full-width checkpoint
    is taken."""
    import torch

    from repro_torch.configs import SHAPES, TrainConfig, get_bundle
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    cfg = get_bundle(TRAIN_ARCH).model
    out = {"card": card}
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    _train_full_width(cfg, TrainConfig(), SHAPES[TRAIN_SHAPE].seq_len, out)
    torch.cuda.empty_cache()
    out["card_vs_cpu"] = _train_card_vs_cpu(cfg)
    out["pipeline"] = _train_pipeline()
    counts = _path_counts("train", ())
    if any(counts.values()):
        raise AssertionError(f"the train path launched a kernel: {counts}")
    out["restart_drill"] = _train_restart_drill()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [train] phase {out['phase_s']:.1f} s, {card}")
    print(f"  [train] numbers: {json.dumps(out, default=str)}")
    return counts, out


def phase_small_check():
    """The card's answers against the plain PyTorch path on the CPU, over
    one index state (built on the card, copied to the CPU)."""
    import dataclasses

    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.kernels.ref import unexplained_id_mismatches

    cfg = tapi.IndexConfig(d=128, M=32, K=12, L=32, max_candidates=128,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    wl = Workload(8192, 128, seed=SEED + 7)
    q, w = (t.cpu() for t in wl.batch(64, SEED + 8))
    data = wl.data.cpu()
    int8 = dataclasses.replace(cfg, storage="int8")
    for label, config, spec in (
        ("exact", cfg, tapi.QuerySpec(k=10, mode="exact")),
        ("probe", cfg, tapi.QuerySpec(k=10)),
        ("int8 screened probe", int8, tapi.QuerySpec(k=10, screen_alpha=SCREEN_ALPHA)),
    ):
        gpu = tapi.Index.build(SEED, data, config)
        cpu = tapi.Index(state=gpu.state.to("cpu"), config=config)
        decoded = quant.decode_table(cpu.state.data, cpu.state.scales)
        g = gpu.query(q, w, spec)
        c = cpu.query(q, w, spec)
        same_cand = float((g.n_candidates.cpu() == c.n_candidates).float().mean())
        rows = (g.n_candidates.cpu() == c.n_candidates)
        bad = unexplained_id_mismatches(g.ids.cpu()[rows], c.dists[rows], c.ids[rows], decoded,
                                        q[rows], w[rows], DIST_RTOL, DIST_ATOL)
        err = float((g.dists.cpu()[rows] - c.dists[rows]).nan_to_num(0, 0, 0).abs().max())
        print(f"  {label}: card vs CPU plain path on n=8192 d=128 b=64: same candidate "
              f"count {same_cand:.3f}, max_abs_err {err:.3g}, unexplained id mismatches {bad}")
        if bad or err > 1e-3 or same_cand < 0.95:
            raise AssertionError(f"{label}: card and CPU paths disagree")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--digests"]:
        print(json.dumps(projection_digests()))
        return 0
    if sys.argv[1:] == ["--wl1-times"]:
        print(json.dumps(wl1_times()))
        return 0
    if sys.argv[1:] == ["--restart-drill"]:
        torch.use_deterministic_algorithms(True)
        print(json.dumps(restart_drill()))
        return 0

    run = Run()
    dev = run.phase("device", phase_device)
    run.phase("build", phase_build)
    if run.failures:
        print(f"chip_smoke: FAILED phases: {run.failures}")
        return 1
    svc = run.phase("service set-up (SERVICE workload, f32 theta index, candidates)",
                    Service)
    if svc is None:
        print(f"chip_smoke: FAILED phases: {run.failures}")
        return 1
    run.phase("kernel alsh_project", phase_alsh_project, run, svc)
    run.phase("kernel gather_rerank_topk", phase_gather_rerank, run, svc)
    run.phase("kernel gather_rerank_topk_blocked", phase_gather_rerank_blocked, run, svc)
    run.phase("kernel wl1_scan_topk", phase_scan, run, svc)
    run.phase("kernel wl1_scan", phase_wl1_scan, run)
    run.phase("kernel wl1_rerank", phase_wl1_rerank, run)
    seg = run.phase("two-segment set-up (a full delta, a stream batch's candidates)",
                    TwoSegment, svc)
    if seg is not None:
        run.phase("kernel gather_rerank_topk_two_seg", phase_gather_rerank_two_seg, run, svc, seg)
        run.phase("kernel gather_rerank_topk_blocked_two_seg",
                  phase_gather_rerank_blocked_two_seg, run, svc, seg)
        del seg
    paths = [
        run.phase("main path (SERVICE, theta + l2)", phase_main_path, svc),
        run.phase("main path (SERVICE, int8 and bf16 storage, screen alpha 2 and 0)",
                  phase_quant_path, svc),
        run.phase("main path (SERVICE, theta multiprobe)", phase_multiprobe_path, svc),
        run.phase("main path (SERVICE, stream: insert, delete, two-segment query, compact)",
                  phase_stream_path, svc),
        run.phase("main path (unfused baseline: wl1_scan / wl1_rerank beside the fused kernels)",
                  phase_unfused_path),
        run.phase("main path (SERVICE, early exit: streamed query, explain, serve --stats)",
                  phase_early_exit_path, svc),
        run.phase("main path (SERVICE, persistence: save, load, query)", phase_persist_path, svc,
                  dev["card"]),
        run.phase("main path (SERVICE, quality-first planning and the offline tuner)",
                  phase_plan_path, run, svc, dev["card"]),
        run.phase("main path (SERVICE, the serving broker: ladder, traces, shard chaos)",
                  phase_broker_path, run, svc, dev["card"]),
        run.phase("main path (SERVICE x8 shards, sharded)", phase_sharded_path, svc, dev["card"]),
        run.phase("main path (static_contracts: lint, the audit lattice, seeded regressions, "
                  "SERVICE peak bytes and syncs)", phase_static_contracts, svc, dev["card"]),
        run.phase("main path (lm: full-width gemma3-1b, prefill and decode, plain, with ALSH "
                  "retrieval and a growing datastore)", phase_lm_path, run, dev["card"]),
        run.phase("main path (train: full-width gemma3-1b at S=4096, card vs CPU, restart "
                  "drill, pipeline)", phase_train_path, run, dev["card"]),
    ]
    run.phase("check against the CPU path", phase_small_check)
    if run.failures or any(p is None for p in paths):
        print(f"chip_smoke: FAILED phases: {run.failures}")
        return 1
    # launches: each path's own counts (zeroed just before it), summed
    counts = {name: sum(p[0][name] for p in paths) for name in paths[0][0]}
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    rows = []
    for name, entry in run.kernels.items():
        entry["launches"] = counts[name]
        entry["launches_by_path"] = dict(zip(PATHS, (p[0][name] for p in paths)))
        rows.append({k: entry[k] for k in keys} | {
            k: v for k, v in entry.items() if k not in keys
        })
    print(json.dumps({"kernels": rows, "card": dev["card"]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
