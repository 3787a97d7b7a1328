#!/usr/bin/env python3
"""Card check of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU:
its paths at full width, with the checks that no benchmark cell and no CUDA
test makes.

    python3 chip_smoke.py
    python3 chip_smoke.py --digests    # only alsh_project's output digests
    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 chip_smoke.py --restart-drill  # only the drill

It times no kernel alone. A kernel's speed on the card is the benchmark's,
``roofline.<kernel>`` and ``stage_ms.*`` read from the trace of a cell
(``python3 portbench/run.py --workload <cell> --trace 1``); each kernel's
agreement with its plain version over the shapes that reach each of its
code paths is held by the CUDA tests (``PYTHONPATH=src python -m pytest -q
--noconftest -m cuda tests/test_torch_cuda.py``). Here every kernel call of
one batch of a path is caught (``_capture_kernel_calls``) and, untimed,
made again through the kernel and through its plain version on the same
inputs (``_kernels_against_plain``): the kernels at the shapes the paths
give them. What it times are its paths: batch, tick and step times on the
host clock, and the device's busy time, idle share and top operations over
one call, from a ``torch.profiler`` trace read by
``portbench.trace.Trace`` (``profile``). Rows and queries come from
``portbench``'s ``clusters`` generator with the data parameters of the
benchmark's configuration at the SERVICE width (``workload``).

Phases, each of which fails the run (exit code 1) when it fails:

  1. device: the card's name, the device count, and its name and power
     limit as ``nvidia-smi`` reports them;
  2. build: every CUDA kernel under ``src/repro_torch/kernels/csrc`` is
     compiled with nvcc (one process per source, all started together),
     with the ``-Xptxas -v`` register and shared-memory report;
  3. service set-up, made once and shared by the later phases: the
     ``SERVICE`` configuration's (n=262,144, d=128, M=32, K=12, L=32,
     C=128) clustered rows and query batch, and the f32 theta index built
     over them on the card with ``Index.build`` (one more build profiled);
  4. paths, each with every launch counter zeroed just before its queries
     and read just after; a kernel of the path that was never launched
     fails the run; the f32, quantized, multiprobe, stream, broker, lm and
     families paths then hold their kernel calls against the plain
     versions (``_kernels_against_plain``):
     a. f32: three probe-mode query batches of 1024 with k=10 on the
        service index, recall@10 against exact mode on the first 64
        queries of each, held to a stated floor; ``wl1_rerank`` over the
        candidate rows of 64 of those queries equal, bit for bit, to the
        gather's distances on its split schedule; then one l2 build and
        batch at the same widths with bucket width ``L2_W``; the kernels
        of the theta build, a probe batch, an exact batch of 1024 and of
        64, the re-rank check and the l2 batch against their plain
        versions;
     b. quantized: the same theta index stored as int8 and as bf16 (same
        seed), served at screen α=2 and α=0: ``n_candidates`` must equal
        the f32 index's, recall@10 against the index's own exact mode must
        clear the floor, f32 storage at α=2 must equal α=0, and the
        quantized kernel must launch twice per screened and once per
        unscreened batch; the kernels of one batch of each storage and α
        against their plain versions;
     c. multiprobe: theta, 8 probes per table, up to 3 flipped bits, on
        the f32 index and batch of a probe batch, its keys from the
        ``multiprobe_keys`` kernel; its j-th distance is never worse than
        the probe batch's; the kernels of one batch against their plain
        versions;
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
        unscreened batch; the kernels of tick 12's batch and exact check
        and of the int8 index's first tick at both α against their plain
        versions;
     e. early exit (see ``phase_early_exit_path``): the streamed query at
        slack 0 equals the monolithic one (sealed f32, mutable, int8 with
        the screen off); at slack 0.1, probe and multiprobe, its batch
        time, windows probed, stop reasons and recall@10 (held to the
        floor); ``Index.explain`` and ``serve --early-exit --stats``;
     f. persistence (see ``phase_persist_path``): ``Index.save`` then
        ``Index.load`` with the default device, at the service width: the
        f32 sealed index, int8 and f32 mutable indexes after two stream
        ticks, a bf16 sealed index; every leaf equal by bits and every
        query bit-equal with equal launch counts (the mutable ones also
        after one more tick and after a compact); the save and load
        seconds and the bytes on disk beside the card's name and power
        limit; a flipped payload byte and a removed COMMIT raise their
        named errors; msgpack and ml_dtypes are never imported;
     g. planning (see ``phase_plan_path``): a ``QualitySpec`` build at the
        service width with the default planner, then one calibrating on
        the workload's weights (its geometry, attempts and seconds, each
        calibration rung's ms), ``query(quality)`` bit-equal to
        ``query(plan)`` with its ms, device time and held-out recall beside
        the explicit SERVICE index's, the ladder and ``explain``, the int8
        index's plan through the blocked gather, the memo through
        save/load (no calibration after the load), the tuner over the
        service's rows inline and on two spawned workers (equal records,
        equal launches) with its table as a prior at the 0.9 target, and
        the candidates per ms of a batch's wall time;
     h. serving (see ``phase_broker_path``): a ``QualitySpec`` build at the
        service width with the default planner and its degradation ladder
        (at least two rungs, each rung's held-out recall), each rung timed
        through the ``Broker`` at buckets 1, 8 and 64, a Poisson and a
        bursty trace of 2000 requests at rates derived from rung 0's time,
        a 4-shard ``ShardSet`` whose exact mode equals the single index's,
        and its chaos drill (a shard killed mid-trace, two failed reloads,
        recovery, bit-identical answers after it); no kernel built after
        warmup; then the kernels against their plain versions on the
        inputs rung 0 gave them (b=1, b=64, the b=64 calibration batch);
     i. sharded (see ``phase_sharded_path``): 8 x 262,144 clustered rows
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
     j. static contracts (see ``phase_static_contracts``): the port's tree
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
     k. lm (see ``phase_lm_path``): full-width gemma3-1b with parameters
        drawn on the card, the prefill of 4 prompts of 64 tokens and 16
        greedy decode steps plain, with ALSH retrieval over 65,536 records
        (``RetrievalConfig()``) and with a growing datastore (one
        ``extend_datastore`` a step): ms per step (median of 3 loops),
        launches per step (one projection, one dedupe and one gather a
        retrieval step),
        device busy and idle share, the host time's split, peak bytes and
        host syncs of a step, recall@8 against exact mode; then the exact
        lookup and its scan against the plain path, recall on uniform and
        near-duplicate keys, each lookup against the CPU plain path over a
        copy of its datastore (ids equal, kNN log-probs within 1e-5), the
        kernels at the decode shapes against their plain versions, the
        reduced model on the card against the CPU (logits 1e-4, tokens equal), and the
        full-width f32 prefill/decode gap at S=512 (within 2e-2) and S=600
        (printed);
     l. train (see ``phase_train_path``): full-width gemma3-1b under
        ``TrainConfig()`` at S=4096, batch 2 (1 past a 72 GB allocator
        peak): a warm-up and 5 timed steps (ms a step, tokens/s), one
        profiled and its ATen ops counted, the peak, loss and grad norm
        finite beside ln V; 2
        steps at microbatch 2 with int8_ef; the reduced model's loss, grads
        and one step on the card against the CPU (the update by its
        relative L2 over the tree and, leaf by leaf, at most 1% of the
        entries off by more than 0.05 of the lr); ``pipeline_apply`` over 4
        stages on the card against the sequential stages; and the restart
        drill in a process of its own (``--restart-drill``,
        deterministic): a failure at step 7 and a restart from the step-5
        commit, async checkpoints, equal to the clean run bit for bit, its
        last commit restored on the CPU leaf for leaf. No kernel runs on
        this path (launches 0);
     m. families (see ``phase_families_path``): hubert-xlarge, qwen2-vl-2b,
        mamba2-2.7b and zamba2-7b at full width and llama4-scout-17b-16e
        with its depth cut to 2 units, one at a time: encode or prefill, 16
        decode steps (plain; with retrieval for qwen2-vl and mamba2, one
        ``alsh_project`` and one ``gather_rerank_topk`` a step), the f32
        prefill/decode gaps, full-width train steps for hubert and
        qwen2-vl, each family's init and step numbers; all six families
        reduced on the card against the CPU (logits 1e-4, tokens equal, MoE
        layers 1e-5 with and without dropped tokens, one train step under
        the train path's bars); then the retrieval steps' kernels at their
        captured shapes against their plain versions;
     n. mesh (see ``phase_mesh_path``): ``launch.dryrun`` over every
        runnable (arch x shape) of the ten archs on the abstract pod1
        mesh, the llama4 train_4k cells also on pod2 and under
        ``--optimized``, each cell's step run on meta tensors at its global
        shape in worker processes (ok or skipped, with argument bytes a
        device, aten ops and the whole-program live peak); the decode
        cells predicted to fit the card run on a (1, 1) mesh of cuda:0
        (the bytes asked of the allocator equal to the predicted argument
        bytes, the allocator's peak beside the live peak, ms a step); the
        MoE mesh impls on a (2, 4) mesh of the card (ep_shardmap against
        gspmd, a2a_shardmap with drops against the CPU, grads finite). No
        kernel runs on this path (launches 0);
  5. check: on a small input, the card's answers agree with the plain
     PyTorch path on the CPU over the same index state (f32 probe and
     exact, int8 screened probe).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device,
or without the rest of the repository beside it, the script exits non-zero
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
DIST_RTOL = DIST_ATOL = 1e-5  # f32 sums over d=128 in different orders
WL1_RTOL = WL1_ATOL = 1e-4  # wl1_scan / wl1_rerank, elementwise against the plain version
PROJ_ATOL = 2e-3  # |projection| <~ 100, 128 f32 terms: rounding <~ 128 * 2**-24 * 100
MP_SCORE_RTOL = 1e-6  # multiprobe keys may differ only between subsets scored this close
KERNEL_ENTRIES = ("alsh_project", "multiprobe_keys", "dedupe_candidates", "gather_rerank_topk",
                  "wl1_scan_topk", "wl1_scan", "wl1_rerank")  # every entry of kernels/ops.py
SEED = 0
# The benchmark's configuration at the SERVICE width (d=128), whose data
# parameters every workload here is drawn with: clusters of near-duplicates
# around centres, so each query's true top-10 is its own cluster
DATA_CONFIG = "sift1m-theta"
THETA_RECALL_FLOOR = 0.5  # mean probe recall@10 over a batch's first 64 queries
L2_W = 64.0  # l2 bucket width of the l2 batch (the projections' scale; see PERF.md)
L2_RECALL_FLOOR = 0.5
QUANT_RECALL_FLOOR = 0.5  # recall@10 of a quantized batch against its own exact mode
SCREEN_ALPHA = 2.0  # the serve CLI's default --screen-alpha
# The stream path: the reference service's defaults (serve --mode stream)
STREAM_CAP = 8192  # --delta-capacity
STREAM_THRESHOLD = 0.75  # --compact-threshold
STREAM_INGEST = 512  # --ingest: 32 new clusters of 16 rows a tick
STREAM_RETIRE = 128  # --retire
STREAM_TICKS = 13  # the 12th reaches the threshold; the 13th runs after the compact
STREAM_ON_NEW = 32  # queries of a stream batch that sit on the tick's new centres
STREAM_HIT_FLOOR = 0.9  # share of those that must return a delta id
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


class Run:
    def __init__(self):
        self.failures: list[str] = []

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


def workload(n: int, d: int, seed: int = SEED):
    """n clustered rows (n, d) on the card, ``.rows``, and their centres:
    the benchmark's ``Clusters`` with ``DATA_CONFIG``'s data parameters;
    ``.batch(b, seed)`` draws b queries on distinct centres and their
    weights."""
    from portbench import bench
    from portbench.datagen.clusters import Clusters

    config = bench.read_json(bench.PORTBENCH / "configs" / f"{DATA_CONFIG}.json")
    return Clusters(config["data"], n, d, seed, "cuda")


class Service:
    """What the SERVICE phases share, made once: the clustered workload
    ``wl``, the service batch ``q``/``w`` and the f32 theta ``index`` over
    the rows."""

    def __init__(self):
        import torch

        import repro_torch.api as tapi
        from repro_torch.configs.paper_alsh import SERVICE

        cfg = SERVICE.index_config
        self.wl = workload(SERVICE.n_per_shard, SERVICE.d)
        self.q, self.w = self.wl.batch(SERVICE.query_batch, SEED + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.index = tapi.Index.build(SEED + 2, self.wl.rows, cfg)
        torch.cuda.synchronize()
        print(f"  [theta] built the f32 index over n={self.index.n} d={cfg.d} K={cfg.K} "
              f"L={cfg.L} C={cfg.max_candidates} on {self.index.device} in "
              f"{time.perf_counter() - t0:.3f} s")
        profile("of one Index.build (SERVICE)",
                lambda: tapi.Index.build(SEED + 2, self.wl.rows, cfg), unprofiled_wall=True)


def stream_rows(seed: int, d: int):
    """STREAM_INGEST new rows and their new centres, drawn on the card as
    ``workload`` draws its rows."""
    wl = workload(STREAM_INGEST, d, seed)
    return wl.centres, wl.rows


def stream_batch(wl, centres, seed: int):
    """A service batch whose first ``len(centres)`` queries sit on the given
    (new) centres, jittered as ``wl.batch`` jitters its queries."""
    import torch

    from repro_torch.configs.paper_alsh import SERVICE

    q, w = wl.batch(SERVICE.query_batch, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    m = centres.shape[0]
    q[:m] = centres + float(wl.p["jitter"]) * torch.randn(centres.shape, generator=gen,
                                                          device="cuda")
    return q.contiguous(), w


def digest(t) -> str:
    """The first 16 hex digits of the sha256 of a tensor's bytes."""
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def projection_digests() -> dict:
    """``alsh_project``'s output digests at build and query width on the
    service rows and batch under SERVICE's tables, through
    ``ops.alsh_project(levels, folded, weights)`` alone, so that the same
    file run beside an older tree of the repository (``python3
    chip_smoke.py --digests``) compares two trees' kernels byte for byte."""
    import torch

    from repro_torch.configs.paper_alsh import SERVICE
    from repro_torch.core import hash_families as hf
    from repro_torch.core.transforms import discretize
    from repro_torch.kernels import ops

    cfg = SERVICE.index_config
    wl = workload(SERVICE.n_per_shard, SERVICE.d)
    q, w = wl.batch(SERVICE.query_batch, SEED + 1)
    tables = hf.make_prefix_tables(torch.Generator().manual_seed(SEED), cfg.lsh_params)
    folded = tables.folded.to(wl.rows.device).contiguous()
    return {label: digest(ops.alsh_project(levels, folded, weights))
            for label, levels, weights in (("build", discretize(wl.rows, cfg.space), None),
                                           ("query", discretize(q, cfg.space), w))}


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
        index = tapi.Index.build(SEED + 2, wl.rows, cfg)
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
    """Print the device's busy time and idle share over one call of ``fn``
    and its ``top`` device operations, read as the benchmark reads a window
    (``portbench.trace.Trace`` over a ``torch.profiler`` trace, the call
    inside a ``portbench.window`` span; diagnostics, the run does not depend
    on them), and return the busy time in us (None when not measured). With
    ``unprofiled_wall`` the same call is first timed without the profiler,
    and the idle share is also estimated against that wall time. A dict
    ``into`` receives the walls, the busy time and the top operations."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    from portbench.trace import WINDOW_SPAN, Trace

    torch.cuda.synchronize()
    plain_wall_us = None
    if unprofiled_wall:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_wall_us = (time.perf_counter() - t0) * 1e6
    try:
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW_SPAN):
                fn()
                torch.cuda.synchronize()
        trace = Trace.from_profiler(prof)
    except Exception as e:  # diagnostics only: a profiler fault must not fail the run
        print(f"  profile {label}: not measured ({type(e).__name__}: {e})")
        return None
    busy_us = 0.0 if trace is None else trace.busy_s() * 1e6
    if busy_us == 0:
        print(f"  profile {label}: no device time recorded (not measured)")
        return None
    wall_us = trace.window_s * 1e6
    print(f"  profile {label}: wall {wall_us:.0f} us (profiler on), device busy {busy_us:.0f} us, "
          f"idle share {max(0.0, 1 - busy_us / wall_us):.3f}")
    if plain_wall_us is not None:
        print(f"  profile {label}: the same call without the profiler just before: wall "
              f"{plain_wall_us:.0f} us; estimated idle share (profiled busy / unprofiled wall) "
              f"{max(0.0, 1 - busy_us / plain_wall_us):.3f}")
    ops = trace.device_ops(top)
    for name, secs in ops:
        print(f"    {secs * 1e6:9.1f} us  {name[:90]}")
    if into is not None:
        into.update(wall_us=wall_us, unprofiled_wall_us=plain_wall_us, busy_us=busy_us,
                    top=[(name[:120], secs * 1e6) for name, secs in ops])
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


def _rerank_equals_gather(index, q, w, k):
    """``wl1_rerank`` over the rows ``data[ids]`` of a probe batch's deduped
    candidates, sorted, must give ``gather_rerank_topk``'s first k distances
    on the same ids bit for bit: both sum a row in one order (the gathers'
    row body). At b=64 the gather cuts each query's slots into several
    splits, a schedule the CUDA tests hold against the re-rank only through
    the one-warp schedule."""
    import torch

    import repro_torch.api as tapi
    from repro_torch.kernels import ops
    from repro_torch.kernels.gather_rerank import f32_splits

    call = _capture_kernel_calls(lambda: index.query(q, w, tapi.QuerySpec(k=k)),
                                 names=("gather_rerank_topk",))["gather_rerank_topk"][-1]
    data, ids = call["data"], call["ids"]
    n = data.shape[0]
    fused, _ = ops.gather_rerank_topk(data, ids, q, w, k)
    dists = ops.wl1_rerank(data[ids.clamp(max=n - 1).long()], q, w)
    dists = torch.where(ids < n, dists, torch.full_like(dists, float("inf")))
    same = torch.equal(torch.sort(dists, dim=1).values[:, :k], fused)
    print(f"  [theta] wl1_rerank over data[ids] of a batch's candidates {tuple(ids.shape)}, "
          f"sorted, against gather_rerank_topk (S={f32_splits(data, ids)}): dists bit-equal "
          f"{same}")
    if not same:
        raise AssertionError("wl1_rerank's distances differ from gather_rerank_topk's")


def phase_main_path(svc):
    import repro_torch.api as tapi
    from repro_torch.kernels import _build

    wl, cfg = svc.wl, svc.index.config
    spec, exact = tapi.QuerySpec(k=10), tapi.QuerySpec(k=10, mode="exact")
    _build.reset_launch_counts()
    index, q, w, theta = _serve("theta", 3, wl, index=svc.index)
    profile("of one theta probe batch", lambda: index.query(q, w, spec), unprofiled_wall=True)
    q64, w64 = q[:64].contiguous(), w[:64].contiguous()
    _rerank_equals_gather(index, q64, w64, 10)
    l2_index, l2q, l2w, l2 = _serve("l2", 1, wl, W=L2_W)
    _path_counts("f32", ("alsh_project", "dedupe_candidates", "gather_rerank_topk",
                         "wl1_scan_topk", "wl1_rerank"))
    for family, rows, floor in (("theta", theta, THETA_RECALL_FLOOR), ("l2", l2, L2_RECALL_FLOOR)):
        rec = sum(r["recall"] for r in rows) / len(rows)
        print(f"  [{family}] mean recall@10 {rec:.3f} (floor {floor})")
        if rec < floor:
            raise AssertionError(f"{family} probe recall@10 {rec:.3f} is under its floor {floor}")
    b = q.shape[0]
    _kernels_against_plain("f32", {
        f"the theta build n={index.n}": _capture_kernel_calls(
            lambda: tapi.Index.build(SEED + 2, wl.rows, cfg)),
        f"a theta probe batch b={b}": _capture_kernel_calls(lambda: index.query(q, w, spec)),
        f"an exact batch b={b}": _capture_kernel_calls(lambda: index.query(q, w, exact)),
        "the exact check b=64": _capture_kernel_calls(lambda: index.query(q64, w64, exact)),
        "the rerank check b=64": _capture_kernel_calls(
            lambda: _rerank_equals_gather(index, q64, w64, 10), names=("wl1_rerank",)),
        f"an l2 probe batch b={b}": _capture_kernel_calls(lambda: l2_index.query(l2q, l2w, spec)),
    })


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
    calls = {}
    for storage in ("int8", "bf16"):
        t0 = time.perf_counter()
        index = tapi.Index.build(SEED + 2, wl.rows, dataclasses.replace(cfg, storage=storage))
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
            calls[f"a {storage} batch b={b}, alpha={alpha}"] = _capture_kernel_calls(
                lambda: index.query(q, w, spec))
        if storage == "int8":
            profile("of one int8 screened batch",
                    lambda: index.query(q, w, tapi.QuerySpec(k=k, screen_alpha=SCREEN_ALPHA)),
                    unprofiled_wall=True)
    # f32 timed again after the quantized batches: f32, quantized, f32 in turns
    print(f"  [f32] the same batch again: {_median_ms(f32, q, w, tapi.QuerySpec(k=k)):.2f} ms "
          f"(median of 5 warm calls)")
    _path_counts("quantized", ("alsh_project", "dedupe_candidates", "gather_rerank_topk_blocked",
                               "wl1_scan_topk"))
    _kernels_against_plain("quantized", calls)


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
    _path_counts("multiprobe", ("alsh_project", "multiprobe_keys", "dedupe_candidates",
                                "gather_rerank_topk"))
    _kernels_against_plain("multiprobe", {f"a multiprobe batch b={b}": _capture_kernel_calls(
        lambda: index.query(q, w, mspec))})


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
    index = tapi.Index.build(SEED + 2, wl.rows, cfg, update=update)
    torch.cuda.synchronize()
    print(f"  [stream] built the mutable f32 index n={index.n} delta_capacity={STREAM_CAP} in "
          f"{time.perf_counter() - t0:.3f} s; table_bytes {index.table_bytes}")
    empty = index.query(svc.q, svc.w, spec)
    same = all(torch.equal(getattr(empty, f), getattr(sealed, f))
               for f in ("ids", "dists", "n_candidates"))
    print(f"  [stream] empty delta: answers equal the sealed index's bit for bit: {same}")
    if not same:
        raise AssertionError("a mutable index with an empty delta must answer as the sealed one")

    calls, next_retire = {}, 0
    for t in range(1, STREAM_TICKS + 1):
        centres, rows = stream_rows(SEED + 1000 + t, d)
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
        if index.needs_compact != (t == 12):
            raise AssertionError(f"tick {t}: needs_compact is {index.needs_compact} at fill "
                                 f"{index.delta_fill}")
        if index.needs_compact:
            profile(f"of one stream batch (tick {t}, fill {index.delta_fill})",
                    lambda: index.query(q, w, spec), unprofiled_wall=True)
            calls[f"a batch b={b}, fill {index.delta_fill}"] = _capture_kernel_calls(
                lambda: index.query(q, w, spec))
            calls[f"the exact check b=64, fill {index.delta_fill}"] = _capture_kernel_calls(
                lambda: index.query(q[:64], w[:64], exact))
            live = torch.from_numpy(index.live_ids()).to("cuda")
            survivors = torch.cat([index.state.data, index.delta.data])[live]  # f32: raw rows
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            compacted = index.compact()
            torch.cuda.synchronize()
            compact_ms = (time.perf_counter() - t0) * 1e3
            fresh = tapi.Index.build(SEED + 2, survivors, cfg, update=update)
            same_state = all(torch.equal(getattr(compacted.state, f), getattr(fresh.state, f))
                             for f in ("sorted_keys", "perm", "data", "levels"))
            a, f_ = compacted.query(q, w, spec), fresh.query(q, w, spec)
            same_ans = all(torch.equal(getattr(a, f), getattr(f_, f))
                           for f in ("ids", "dists", "n_candidates"))
            print(f"  [stream] compacted to n={compacted.n} in {compact_ms:.2f} ms; "
                  f"sorted_keys/perm/data/levels equal Index.build over the survivors: "
                  f"{same_state}; answers equal: {same_ans}")
            if not (same_state and same_ans):
                raise AssertionError("compact() differs from a fresh build over the survivors")
            index, next_retire = compacted, 0

    # int8 beside f32, two ticks of the same operations
    twin = {s: tapi.Index.build(SEED + 2, wl.rows, dataclasses.replace(cfg, storage=s),
                                update=update) for s in ("f32", "int8")}
    for t in range(1, 3):
        centres, rows = stream_rows(SEED + 3000 + t, d)
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
            if t == 1:
                calls[f"an int8 batch b={b}, alpha={alpha}, fill "
                      f"{twin['int8'].delta_fill}"] = _capture_kernel_calls(
                    lambda: twin["int8"].query(q, w, qspec))
    _path_counts("stream", ("alsh_project", "dedupe_candidates", "gather_rerank_topk_two_seg",
                            "gather_rerank_topk_blocked_two_seg"))
    _kernels_against_plain("stream", calls)


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

    slack0("f32 probe", index, q, w, tapi.QuerySpec(k=k))
    update = tapi.UpdateSpec(delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD)
    mut = tapi.Index.build(SEED + 2, svc.wl.rows, cfg, update=update)
    centres, new_rows = stream_rows(SEED + 5000, cfg.d)
    mut = mut.insert(new_rows)[0].delete(torch.arange(0, STREAM_RETIRE, dtype=torch.int32,
                                                      device="cuda"))
    qs, ws = stream_batch(svc.wl, centres, SEED + 5001)
    slack0(f"f32 mutable, delta fill {mut.delta_fill}", mut, qs, ws, tapi.QuerySpec(k=k))
    del mut
    int8 = tapi.Index.build(SEED + 2, svc.wl.rows, dataclasses.replace(cfg, storage="int8"))
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
    _path_counts("early exit", ("alsh_project", "dedupe_candidates", "gather_rerank_topk",
                                "gather_rerank_topk_two_seg", "gather_rerank_topk_blocked",
                                "wl1_scan_topk"))


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
    return loaded


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
    update = tapi.UpdateSpec(delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD)

    def tick(idx, t):
        _, new = stream_rows(SEED + 5000 + t, d)
        retire = torch.arange((t - 1) * STREAM_RETIRE, t * STREAM_RETIRE, dtype=torch.int32,
                              device="cuda")
        return idx.insert(new)[0].delete(retire)

    # set-up, off the path's counts: the indexes to be saved
    mutable = {}
    for storage in ("int8", "f32"):
        idx = tapi.Index.build(SEED + 2, wl.rows, dataclasses.replace(cfg, storage=storage),
                               update=update)
        for t in (1, 2):
            idx = tick(idx, t)
        mutable[storage] = idx
    bf16 = tapi.Index.build(SEED + 2, wl.rows, dataclasses.replace(cfg, storage="bf16"))
    small = tapi.Index.build(SEED, workload(8192, d, seed=SEED + 7).rows, cfg)
    del idx
    _build.reset_launch_counts()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_persist_") as tmp:
        # 1. the f32 sealed service index
        loaded = _round_trip("f32 sealed", svc.index, os.path.join(tmp, "f32"), card)
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
            back = _round_trip(label, idx, os.path.join(tmp, storage + "_mut"), card)
            _same_state(label, idx, back)
            q, w = stream_batch(wl, stream_rows(SEED + 5000 + 2, d)[0], SEED + 5100)
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
        back = _round_trip("bf16 sealed", bf16, os.path.join(tmp, "bf16"), card)
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
    _path_counts("persist", ("alsh_project", "gather_rerank_topk", "gather_rerank_topk_two_seg",
                             "gather_rerank_topk_blocked", "gather_rerank_topk_blocked_two_seg",
                             "wl1_scan_topk"))


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


def phase_plan_path(svc, card):
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
    7. the candidates per ms of batch wall time the card re-ranks on the f32
       probe batch beside the planner's ``candidates_per_ms`` default
       (unchanged: both packages must choose alike)."""
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
            default = tapi.Index.build(SEED + 2, wl.rows, quality, family="theta", M=32)
    except ValueError as e:
        if "no hash family yields usable" not in str(e):
            raise
        print(f"  [plan] default planner (weights |N(0,1)|+0.1): the theory solve refused "
              f"after {time.perf_counter() - t0:.3f} s: {str(e)[:110]}")
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
        del default
    planner = _timed_planner(tapi, weights)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        index = tapi.Index.build(SEED + 2, wl.rows, quality, family="theta", M=32,
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
    profile("of one planned batch", lambda: index.query(q, w, plan), top=6)
    profile("of one explicit SERVICE batch", lambda: svc.index.query(q, w, explicit), top=6)
    held = recall_at_k(index.query(hq, hw, plan).ids, index.query(hq, hw, exact).ids, k)
    held_service = recall_at_k(svc.index.query(hq, hw, explicit).ids,
                               svc.index.query(hq, hw, exact).ids, k)
    print(f"  [plan] batch of {b}: planned {ms_plan:.3f} ms, explicit SERVICE {ms_service:.3f} "
          f"ms; held-out "
          f"recall@{k} on {PLAN_HELD_OUT} queries {held:.4f} (predicted_recall "
          f"{plan.predicted_recall:.4f}; SERVICE {held_service:.4f}); {card}")

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

    # 4. a quantized index plans: its screened rungs run the blocked gather
    int8 = tapi.Index.build(SEED + 2, wl.rows,
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
    del int8

    # 5. the plan memo persists
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
        loaded = _round_trip("planned index", index, os.path.join(tmp, "planned"), card)
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
        real = wl.rows.cpu().numpy()
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

    # 7. candidates per ms on the f32 probe batch
    valid = int(svc.index.query(q, w, explicit).n_candidates.sum())
    per_ms = valid / ms_service
    print(f"  [plan] the f32 probe batch re-ranks {valid} candidates: {per_ms:.0f} per ms of "
          f"batch wall time (Planner.candidates_per_ms default "
          f"{tapi.Planner().candidates_per_ms:.0f}); {card}")
    _path_counts("plan", ("alsh_project", "gather_rerank_topk", "gather_rerank_topk_blocked",
                          "wl1_scan_topk"))


def _capture_kernel_calls(fn, names=KERNEL_ENTRIES):
    """Run ``fn`` with the entries ``names`` of ``ops`` spied on (by default
    all of them) and return ``{name: [arguments, ...]}`` of their calls, in
    order, each a dict of every parameter by name."""
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


def _flip_scores(proj, keys):
    """The float64 score of the flip subset behind each (b, L, P) key: the
    |proj| summed over the bits where the key differs from the sign key."""
    import torch

    K = proj.shape[-1]
    bit = torch.ones((), dtype=torch.int64, device=proj.device) << torch.arange(
        K, device=proj.device)
    base = ((proj >= 0).long() * bit).sum(-1)
    bits = ((keys.long() ^ base[..., None])[..., None] & bit) != 0  # (b, L, P, K)
    return (bits * proj.double().abs()[:, :, None, :]).sum(-1)


def _against_plain(label, name, a):
    """One captured call ``a`` of ``ops.<name>`` made again on the card and
    through its plain version, on the same inputs; prints what was compared
    and fails where they disagree. The top-k entries are held by
    ``_check_topk`` (a stored table decoded, a delta appended), the
    projection by ``PROJ_ATOL`` and its signs away from 0, the multiprobe
    keys bit for bit on dyadic projections and up to near-equal scores on
    the raw ones, the dedupe bit for bit, the materializing distances by
    ``WL1_RTOL``."""
    import torch

    from repro_torch import quant
    from repro_torch.kernels import ops

    plain = dict(a, force="plain")
    if name in ("wl1_scan_topk", "gather_rerank_topk"):
        got, want = getattr(ops, name)(**a), getattr(ops, name)(**plain)
        table = a["data"]
        if name == "gather_rerank_topk":
            if a["delta"] is not None:
                table = torch.cat([table, a["delta"].to(table.dtype)])
            if table.dtype != torch.float32 or a["scales"] is not None:
                table = quant.decode_table(table, a["scales"])
            what = (f"{a['data'].dtype} table {tuple(a['data'].shape)}"
                    f"{', scaled' if a['scales'] is not None else ''}"
                    f"{'' if a['delta'] is None else f', delta {tuple(a['delta'].shape)}'}, "
                    f"ids {tuple(a['ids'].shape)}")
        else:
            what = f"data {tuple(table.shape)}, b={a['queries'].shape[0]}"
        _check_topk(f"{label}: {what}, k={a['k']}", got, want, table, a["queries"],
                    a["weights"])
        return
    if name == "alsh_project":
        got, want = ops.alsh_project(**a), ops.alsh_project(**plain)
        err = float((got - want).abs().max())
        far = want.abs() > PROJ_ATOL  # theta codes are compared away from 0 only
        flips = int(((got >= 0) != (want >= 0))[far].sum())
        ok = err <= PROJ_ATOL and not flips
        what = (f"levels {tuple(a['levels'].shape)}, H={a['folded'].shape[0]}, "
                f"{'weighted' if a['weights'] is not None else 'unweighted'}: max_abs_err "
                f"{err:.3g} (atol {PROJ_ATOL}), theta-code flips away from 0: {flips}")
    elif name == "multiprobe_keys":
        dyadic = dict(a, proj_lk=torch.round(a["proj_lk"] * 256) / 256)  # exact subset sums
        exact = torch.equal(ops.multiprobe_keys(**dyadic),
                            ops.multiprobe_keys(**dict(dyadic, force="plain")))
        got, want = ops.multiprobe_keys(**a), ops.multiprobe_keys(**plain)
        differ = got != want
        sg, sw = _flip_scores(a["proj_lk"], got), _flip_scores(a["proj_lk"], want)
        gap = float(((sg - sw).abs() / torch.maximum(sg, sw).clamp_min(1e-30))[differ].max()
                    ) if bool(differ.any()) else 0.0
        ok = exact and gap <= MP_SCORE_RTOL
        what = (f"proj {tuple(a['proj_lk'].shape)}, {a['n_probes']} probes, {a['max_flips']} "
                f"flips: keys {tuple(got.shape)} bit-equal on dyadic projections {exact}; on "
                f"the raw ones {int(differ.sum())} differ, largest relative score gap "
                f"{gap:.3g} (limit {MP_SCORE_RTOL})")
    elif name == "dedupe_candidates":
        (gi, gn), (wi, wn) = ops.dedupe_candidates(**a), ops.dedupe_candidates(**plain)
        ok = torch.equal(gi, wi) and torch.equal(gn, wn)
        what = f"cand {tuple(a['cand'].shape)}, n={a['n']}: ids and counts bit-equal {ok}"
    else:  # wl1_scan, wl1_rerank
        got, want = getattr(ops, name)(**a), getattr(ops, name)(**plain)
        diff = (got - want).abs()
        ok = (bool((diff <= WL1_ATOL + WL1_RTOL * want.abs()).all())
              and bool(torch.isfinite(got).all()))
        rows = a["data"] if name == "wl1_scan" else a["pts"]
        what = (f"rows {tuple(rows.shape)}, b={a['queries'].shape[0]}: max_abs_err "
                f"{float(diff.max()):.3g} (rtol/atol {WL1_RTOL})")
    print(f"  {label}: {what}")
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")


def _kernels_against_plain(path, calls_by_label, sealed_f32=False):
    """Every kernel call a path made, as ``_capture_kernel_calls`` caught
    it (``calls_by_label``: label -> {entry: [arguments, ...]}), against
    the plain version on the same inputs (``_against_plain``). With
    ``sealed_f32`` a gather with a delta or scales fails the path (its index
    is a sealed f32 one). Untimed; run after the path's launch counts are
    read."""
    for label, calls in calls_by_label.items():
        for name, args in calls.items():
            for i, a in enumerate(args):
                where = f"[{path}] {name} at {label}, call {i + 1} of {len(args)}"
                if sealed_f32 and name == "gather_rerank_topk" and (
                        a["scales"] is not None or a["delta"] is not None):
                    raise AssertionError(f"{where}: the sealed f32 index gathered with a delta "
                                         f"or scales")
                _against_plain(where, name, a)


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


def phase_broker_path(svc, card):
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
    5. after the path's counts are read: the kernels against their plain
       versions on the inputs rung 0 gave them (b=1, b=64, and the
       planner's b=64 calibration batch), see ``_kernels_against_plain``."""
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
        index = tapi.Index.build(SEED + 2, wl.rows, quality, family="theta", M=32)
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
              + ", ".join(f"b={b} {grid[(r, b)]:.3f}" for b in BROKER_BUCKETS))
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
    _path_counts("broker", ("alsh_project", "gather_rerank_topk", "wl1_scan_topk"))
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
    _kernels_against_plain("broker", calls, sealed_f32=True)
    print(f"  [broker] summary {json.dumps(rows, default=str)}")


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
    wl = workload(S * n_local, cfg.d, seed=SEED + 60)
    # permute before the partition: otherwise every cluster sits in one shard
    gen = torch.Generator(device="cuda").manual_seed(SEED + 61)
    wl.rows = wl.rows[torch.randperm(wl.rows.shape[0], generator=gen, device="cuda")]
    q, w = wl.batch(b, SEED + 62)
    mesh = tdist.make_mesh(SHARD_MESH, SHARD_AXES, devices=[torch.device("cuda", 0)] * S)
    spec = tapi.QuerySpec(k=k)
    mspec = tapi.QuerySpec(k=k, mode="multiprobe", n_probes=8, max_flips=3)
    exact = tapi.QuerySpec(k=k, mode="exact")
    out = {"card": card, "n": S * n_local, "shards": S}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    single = tapi.Index.build(SEED + 2, wl.rows, cfg)
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
    alone = tapi.Index(state=build_index(None, wl.rows[:n_local], cfg, tables=single.state.tables,
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
    host = tapi.Index.build(SEED + 2, wl.rows, cfg, update=update)
    for t in range(1, SHARD_TICKS + 1):
        centres, rows = stream_rows(SEED + 5000 + t, cfg.d)
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
    rows = stream_rows(SEED + 5100, cfg.d)[1]
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
    _path_counts("sharded", ("alsh_project", "gather_rerank_topk", "gather_rerank_topk_two_seg",
                             "wl1_scan_topk"))
    print(f"  [sharded] numbers: {json.dumps(out)}")


# The static-contract phase: the kernels the audit lattice launches on the card
# (no query path calls wl1_scan or wl1_rerank)
LATTICE_KERNELS = ("alsh_project", "gather_rerank_topk", "gather_rerank_topk_two_seg",
                   "gather_rerank_topk_blocked", "gather_rerank_topk_blocked_two_seg",
                   "wl1_scan_topk", "multiprobe_keys", "dedupe_candidates")
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
    _path_counts("static_contracts", LATTICE_KERNELS)
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
                and set(row["launches"]) - {"alsh_project", "multiprobe_keys", "dedupe_candidates",
                                            "wl1_scan_topk", *audit.STORED_KERNELS}]
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
    int8 = tapi.Index.build(SEED + 2, svc.wl.rows, dataclasses.replace(cfg, storage="int8"))
    stream = tapi.Index.build(SEED + 2, svc.wl.rows, cfg, update=tapi.UpdateSpec(
        delta_capacity=STREAM_CAP, compact_threshold=STREAM_THRESHOLD))
    for t in range(1, 13):  # the stream path's ticks 1-12, before its compact
        centres, rows = stream_rows(SEED + 1000 + t, cfg.d)
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
    for label, args in batches.items():
        _batch_contracts(label, lambda a=args: a[0].query(*a[1:]))
    print(f"  static_contracts phase: {time.perf_counter() - t_phase:.1f} s (the audit "
          f"{audit_s:.1f} s), {card}")


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
    if isinstance(tree, tuple):  # a batch of trees, a KVCache, a MambaCache
        return [t for v in tree for t in _tree_leaves(v)]
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


def _lm_scan_shape(calls):
    """``wl1_scan_topk`` at the inputs the lm path's exact lookup gave it,
    bit for bit against ``wl1_scan`` and a stable sort; then both kernels
    against their plain versions on those inputs."""
    import torch

    from repro_torch.kernels import ops

    if len(calls) != 1:
        raise AssertionError(f"the exact lookup made {len(calls)} scans, not 1")
    data, q, w, k = (calls[0][x] for x in ("data", "queries", "weights", "k"))
    (n, d), b = data.shape, q.shape[0]
    label = f"the exact lookup n={n} b={b} d={d} k={k}"
    got = ops.wl1_scan_topk(data, q, w, k)
    ref = []
    scans = _capture_kernel_calls(lambda: ref.append(sorted_scan_topk(data, q, w, k)),
                                  names=("wl1_scan",))
    sd, si = ref[0]
    if not (torch.equal(got[0], sd) and torch.equal(got[1], si)):
        raise AssertionError(f"[lm] wl1_scan_topk at {label}: differs from wl1_scan + stable "
                             f"sort")
    print(f"  [lm] wl1_scan_topk at {label}: bit-equal to wl1_scan + stable sort")
    del got, ref, sd, si
    _kernels_against_plain("lm", {label: {"wl1_scan_topk": calls, **scans}})


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


def phase_lm_path(card):
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
       path, and its scan at the captured shape against ``wl1_scan`` and a
       stable sort and both against their plain versions
       (``_lm_scan_shape``); recall on uniform and near-duplicate keys
       beside the decode steps' (``_lm_recall_by_keys``); the lookups of
       the last steps on both datastores against the CPU plain path over
       copies of them (ids equal, dists 1e-5, kNN log-probs 1e-5), and the
       kernels at the path's captured shapes against their plain versions
       (``_kernels_against_plain``);
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
    want = {"retrieval": {"alsh_project": 1, "dedupe_candidates": 1, "gather_rerank_topk": 1},
            "growing": {"alsh_project": 2, "dedupe_candidates": 1,
                        "gather_rerank_topk_two_seg": 1}}
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
    _path_counts("lm", ("alsh_project", "dedupe_candidates", "gather_rerank_topk",
                        "gather_rerank_topk_two_seg", "wl1_scan_topk"))
    print(f"  [lm] allocator peak over the path {out['peak_allocated_bytes']} B "
          f"({out['peak_allocated_bytes'] / 2**30:.2f} GiB)")

    # the exact lookup against the CPU plain path, and its scan at the path's
    # shape against a stable sort and the plain versions; then recall on other keys
    cpu = _datastore_on_cpu(sealed)
    want_exact = cpu.index.query(q_all.cpu(), w_all.cpu(), exact_spec)
    out["exact_against_cpu"] = _against_cpu("[lm] exact lookup, all steps: card vs the CPU "
                                            "plain path", exact, want_exact,
                                            cpu.index.state.data, q_all.cpu(), w_all.cpu())
    print(f"  [lm] exact lookup of the {q_all.shape[0]} decode-step keys: card vs the CPU plain "
          f"path, dists max_abs_err {out['exact_against_cpu']:.3g}, ids equal "
          f"{bool(torch.equal(exact.ids.cpu(), want_exact.ids))}")
    del cpu, want_exact
    _lm_scan_shape(scan_calls)
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
        f"decode step b={B}, growing (fill {state.index.delta_fill})": dict(
            grow_calls, alsh_project=grow_calls["alsh_project"][:1]),
        f"insert b={B}, unweighted": {"alsh_project": grow_calls["alsh_project"][1:]},
    }
    _kernels_against_plain("lm", calls)

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
TRAIN_UPDATE_LR = 0.05  # f32, each leaf: an entry is past when off by 0.05 of the step's lr
TRAIN_NEAR_EPS = 10  # (but not where its |g|, from the CPU's v, is under 10 Adam eps)
TRAIN_UPDATE_SHARE = 0.01  # at most 1% of a leaf's entries past (a small leaf: none)
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


def _update_check(before, want_s, got_s, lr, tcfg) -> dict:
    """One f32 step's parameter update, card (``got_s``) against the CPU
    (``want_s``), both from ``before`` ({leaf name: float64 numpy}): the
    relative L2 error over the tree (TRAIN_UPDATE_L2), and per leaf the
    entries off by more than TRAIN_UPDATE_LR of the lr whose gradient (|g|
    from the CPU's second moment) is at least TRAIN_NEAR_EPS Adam eps: at
    most TRAIN_UPDATE_SHARE of a leaf's entries. Returns the numbers and the
    leaves past their share (``bad_leaves``)."""
    import numpy as np

    params = [k for k in want_s if k.startswith("params/")]
    update_l2 = math.sqrt(sum(float(np.sum((got_s[k] - want_s[k]) ** 2)) for k in params)
                          / sum(float(np.sum((want_s[k] - before[k]) ** 2)) for k in params))
    worst, bad = (-1.0, ""), []
    for k in params:
        g = np.sqrt(want_s["opt/v/" + k[len("params/"):]] / (1 - tcfg.beta2))
        past = (np.abs(got_s[k] - want_s[k]) > TRAIN_UPDATE_LR * lr) & (
            g >= TRAIN_NEAR_EPS * tcfg.eps)
        n_past = int(past.sum())
        worst = max(worst, (n_past / past.size, k))
        if n_past > int(TRAIN_UPDATE_SHARE * past.size):
            bad.append(f"{k}: {n_past} of {past.size}")
    return {"update_rel_l2": update_l2, "worst_leaf_share_past": worst[0],
            "worst_leaf": worst[1], "bad_leaves": bad}


def _step_card_vs_cpu(label, c, tcfg, state, batch, tag="train"):
    """``forward_train``'s loss and gradients and one ``make_train_step`` of
    config ``c`` from the same state and batch (CPU tensors) on the card and
    on the CPU. f32 compute: the loss within TRAIN_F32_LOSS_RTOL, every
    gradient leaf within TRAIN_F32_GRAD_TOL of its largest, the update by
    ``_update_check``, moments within TRAIN_MOMENT_TOL; bf16 compute: the
    loss within TRAIN_BF16_LOSS_TOL and the gradients' relative L2 within
    TRAIN_BF16_GRAD_L2."""
    import numpy as np

    from repro_torch.runtime import train_step as ts

    gpu_state = ts.train_state_from_leaves(ts.train_state_leaves(state), state, "cuda")
    gbatch = {k: v.cuda() for k, v in batch.items()}
    lc, gcpu = ts._value_and_grad(state.params, batch, c)
    lg, gg = ts._value_and_grad(gpu_state.params, gbatch, c)
    want = {k: v.double().numpy() for k, v in _named(gcpu).items()}
    got = {k: v.double().cpu().numpy() for k, v in _named(gg).items()}
    loss_err = abs(float(lg) - float(lc))
    grad_err = max(float(np.max(np.abs(got[k] - want[k]))) / max(
        float(np.max(np.abs(want[k]))), 1e-30) for k in want)
    grad_l2 = math.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in want)
                        / sum(float(np.sum(want[k] ** 2)) for k in want))
    sc, mc = ts.make_train_step(c, tcfg)(state, batch)
    sg, mg = ts.make_train_step(c, tcfg)(gpu_state, gbatch)
    lr = float(mc["lr"])
    before = {k: v.double().numpy() for k, v in ts.train_state_leaves(state).items()}
    want_s = {k: v.double().numpy() for k, v in ts.train_state_leaves(sc).items()}
    got_s = {k: v.double().cpu().numpy() for k, v in ts.train_state_leaves(sg).items()}
    params = [k for k in want_s if k.startswith("params/")]
    param_err = max(float(np.max(np.abs(got_s[k] - want_s[k]))) for k in params)
    update = _update_check(before, want_s, got_s, lr, tcfg)
    moment_err = max(float(np.max(np.abs(got_s[k] - want_s[k]))) / max(
        float(np.max(np.abs(want_s[k]))), 1e-30)
        for k in want_s if k.startswith(("opt/m/", "opt/v/")))
    r = {"loss_cpu": float(lc), "loss_err": loss_err, "grad_err_of_leaf_max": grad_err,
         "grad_rel_l2": grad_l2, "param_err": param_err, "param_err_over_lr": param_err / lr,
         **update, "moment_err_of_leaf_max": moment_err,
         "step_metrics_err": {k: abs(float(mg[k]) - float(mc[k])) for k in mc}}
    print(f"  [{tag}] {label}, card vs CPU: loss {float(lc):.6f} off by {loss_err:.3g}; grads "
          f"off by {grad_err:.3g} of a leaf's largest (rel L2 {grad_l2:.3g}); after one step "
          f"the update off by {update['update_rel_l2']:.3g} (rel L2; largest entry "
          f"{param_err / lr:.3g} of the lr; worst leaf {update['worst_leaf']} with "
          f"{update['worst_leaf_share_past']:.4f} of its entries past {TRAIN_UPDATE_LR} of the "
          f"lr), moments {moment_err:.3g} of a leaf's largest")
    if c.compute_dtype == "float32":
        bad = (loss_err > TRAIN_F32_LOSS_RTOL * abs(float(lc)) or grad_err > TRAIN_F32_GRAD_TOL
               or update["update_rel_l2"] > TRAIN_UPDATE_L2 or update["bad_leaves"]
               or moment_err > TRAIN_MOMENT_TOL)
    else:
        bad = loss_err > TRAIN_BF16_LOSS_TOL or grad_l2 > TRAIN_BF16_GRAD_L2
    if bad:
        raise AssertionError(f"{label}: card and CPU disagree: {r}")
    return r


def _train_card_vs_cpu(cfg):
    """(b): the reduced config, f32 compute and bf16 compute with remat, the
    same parameters on the card and the CPU (``_step_card_vs_cpu``)."""
    import dataclasses

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
        out[compute] = _step_card_vs_cpu(f"reduced {red.name} {compute} compute (remat {remat})",
                                         c, tcfg, state, {"tokens": toks})
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


def phase_train_path(card):
    """Training (``launch/train``'s flow) at the full width of gemma3-1b (26
    layers, d_model 1152, vocab 262,144, f32 parameters drawn on the card,
    bf16 compute, ``remat=True``) under ``TrainConfig()``, at train_4k's
    S=4096 and batch TRAIN_BATCH (cut from 256):

    a. one warm-up step and TRAIN_TIMED_STEPS timed ones (ms per step, the
       median on the host clock to the sync on the loss; tokens/s), one
       step profiled (device busy, idle share, the top device ops) and its
       ATen ops counted, the allocator peak, loss and grad norm finite (the
       loss beside ln V); then
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


FAM_SCOUT_UNITS = 2  # of llama4-scout's 12 units (8 of its 48 layers): ~19.7 B bf16 parameters
FAM_INIT_PEAK_LIMIT = 50e9  # allocator bytes scout's init may peak at (parameters + one f32 draw)
FAM_ENCODE = (4, 1024)  # hubert-xlarge: B, S frames encoded
FAM_SERVE = {  # arch: (text tokens, vision patches, decode with retrieval, consistency S)
    "qwen2-vl-2b": (64, 256, True, ()),
    "mamba2-2.7b": (512, 0, True, (512, 600)),
    "zamba2-7b": (512, 0, False, (512,)),
    "llama4-scout-17b-16e": (64, 0, False, (64,)),
}
FAM_TRAIN = {"hubert-xlarge": (4, 1024), "qwen2-vl-2b": (2, 1024)}  # (B, S) of the train steps
FAM_TRAIN_TIMED = 2  # steps after one warm-up
FAM_REDUCED = ("hubert-xlarge", "qwen2-vl-2b", "llama4-scout-17b-16e",
               "llama4-maverick-400b-a17b", "mamba2-2.7b", "zamba2-7b")
MOE_SCATTER_TOL = 1e-5  # the lm path's scatter tolerance (index_put_ accumulate on the card)
MOE_DROP_FACTOR = 0.5  # a capacity factor at which the reduced MoE layer drops tokens


def _family_config(arch):
    """The full-width config; llama4-scout's depth cut to FAM_SCOUT_UNITS."""
    import dataclasses

    from repro_torch.configs import get_bundle

    cfg = get_bundle(arch).model
    if arch == "llama4-scout-17b-16e":
        cfg = dataclasses.replace(cfg, n_units=FAM_SCOUT_UNITS,
                                  n_layers=FAM_SCOUT_UNITS * len(cfg.scan_unit))
    return cfg


def _free_card():
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _one_step_numbers(tag, label, fn, into):
    """A step's device busy and idle share (profiled) and its ATen ops."""
    prof = {}
    into["device_busy_us"] = profile(f"[{tag}] {label}", fn, top=6, unprofiled_wall=True,
                                     into=prof)
    into["profile"] = prof
    into["aten_ops"] = _count_aten_ops(fn)
    print(f"  [{tag}] {label}: {into['aten_ops']} ATen ops")


def _family_serve(arch, cfg, params, out, calls):
    """Prefill and LM_GEN greedy decode steps (plain, and with retrieval at
    ``RetrievalConfig()`` where FAM_SERVE says so), each variant LM_TIMING_LOOPS
    loops interleaved; one step of each profiled; the decode steps' kernel
    calls captured into ``calls``; then the f32 prefill/decode consistency
    gaps."""
    import dataclasses

    import torch

    from repro_torch.configs import RetrievalConfig
    from repro_torch.kernels import _build
    from repro_torch.runtime import retrieval as rt
    from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step

    n_text, n_patches, retrieval, gap_S = FAM_SERVE[arch]
    B, G, V = LM_BATCH, LM_GEN, cfg.vocab_size
    S = n_text + n_patches
    g = torch.Generator().manual_seed(SEED + 21)
    batch = {"tokens": torch.randint(0, V, (B, n_text), dtype=torch.int32, generator=g)}
    if n_patches:  # the stream's vision batch: patches, and t = h = w grids
        batch["patches"] = torch.randn((B, n_patches, cfg.frontend_dim), generator=g)
        t = torch.arange(S, dtype=torch.int32).expand(B, S)
        batch["positions"] = torch.stack([t, t, t])
    batch = {k: v.cuda() for k, v in batch.items()}
    prefill = make_prefill_step(cfg, cache_len=S + G)
    plain = make_decode_step(cfg)
    steps = {"plain": plain}
    if retrieval:
        rcfg = RetrievalConfig()
        store = rt.build_datastore(SEED + 1, cfg.d_model, V, rcfg, device="cuda")
        retr = make_decode_step(cfg, rcfg)
        steps["retrieval"] = lambda p, b, c: retr(p, b, c, store)
    prefill_ms = []
    for _ in range(2):  # cold, then warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = prefill(params, batch)
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
    if tuple(logits.shape) != (B, V) or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{arch} prefill logits {tuple(logits.shape)} not finite (B, V)")
    out["prefill"] = {"B": B, "S": S, "patches": n_patches, "cold_ms": prefill_ms[0],
                      "warm_ms": prefill_ms[1]}
    print(f"  [families] {arch} prefill B={B} S={S}" + (f" ({n_patches} patches + {n_text} "
          f"tokens)" if n_patches else "") + f": cold {prefill_ms[0]:.2f} ms, warm "
          f"{prefill_ms[1]:.2f} ms")

    def batch_at(i, tok):
        return {"token": tok, "pos": torch.full((B,), S + i, dtype=torch.int32, device="cuda")}

    def loop(name):
        before = _build.launch_counts()
        tok, c, toks = tok0, caches, [tok0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(G):
            mixed, tok, c = steps[name](params, batch_at(i, tok), c)
            toks.append(tok)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / G
        after = _build.launch_counts()
        toks = torch.stack(toks, dim=1).cpu()
        if not bool(torch.isfinite(mixed).all()) or not bool(((toks >= 0) & (toks < V)).all()):
            raise AssertionError(f"{arch} {name} decode: non-finite output or a bad token")
        return {"ms": ms, "toks": toks,
                "launches": {k: (after[k] - before[k]) / G for k in after if after[k] != before[k]}}

    loops = {name: [] for name in steps}
    for _ in range(LM_TIMING_LOOPS):
        for name in steps:
            loops[name].append(loop(name))
    out["decode"] = {}
    for name, runs in loops.items():
        ms_all = [r["ms"] for r in runs]
        if any(r["launches"] != runs[0]["launches"] for r in runs):
            raise AssertionError(f"{arch} {name} decode: the loops launched differently")
        want = ({"alsh_project": 1, "dedupe_candidates": 1, "gather_rerank_topk": 1}
                if name == "retrieval" else {})
        if runs[0]["launches"] != want:
            raise AssertionError(f"{arch} {name} decode launched {runs[0]['launches']} a step, "
                                 f"not {want}")
        d = out["decode"][name] = {"ms_per_step": statistics.median(ms_all),
                                   "ms_per_step_loops": ms_all,
                                   "launches_per_step": runs[0]["launches"],
                                   "first_tokens": runs[0]["toks"][0, :8].tolist()}
        print(f"  [families] {arch} decode {name}: {LM_TIMING_LOOPS} loops of {G} steps x {B} "
              f"seqs, median {d['ms_per_step']:.3f} ms/step (loops "
              f"{[round(x, 3) for x in ms_all]}); launches per step {d['launches_per_step']}; "
              f"first tokens (seq 0) {d['first_tokens']}")
        _one_step_numbers("families", f"{arch} one {name} decode step",
                          lambda: steps[name](params, batch_at(0, tok0), caches), d)
    if retrieval:
        calls[f"{arch} decode step b={B}, d_model {cfg.d_model}"] = _capture_kernel_calls(
            lambda: steps["retrieval"](params, batch_at(0, tok0), caches))
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
    del caches

    gaps = {}
    cfg32 = gap_cfg = dataclasses.replace(cfg, compute_dtype="float32")
    if cfg.moe is not None:  # capacity factor n_experts: no prefill drops a token
        gap_cfg = dataclasses.replace(cfg32, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    for S_c in gap_S:
        gaps[S_c] = _consistency_gap(params, gap_cfg, S_c, SEED + 5)
        print(f"  [families] {arch} prefill({S_c + 1}) against prefill({S_c}) + one decode step, "
              f"f32 compute" + (f", capacity factor {gap_cfg.moe.capacity_factor}" if cfg.moe
                                else "") + f": max |logit gap| {gaps[S_c]:.3g} (bar "
              f"{LM_CONSISTENCY_TOL})")
        if gaps[S_c] > LM_CONSISTENCY_TOL:
            raise AssertionError(f"{arch} prefill/decode gap {gaps[S_c]:.3g} at S={S_c}")
    if cfg.moe is not None:  # the config's capacity factor, which may drop tokens
        S_c = gap_S[0]
        gaps[f"{S_c} at capacity {cfg.moe.capacity_factor}"] = gap = _consistency_gap(
            params, cfg32, S_c, SEED + 5)
        print(f"  [families] {arch} the same at the config's capacity factor "
              f"{cfg.moe.capacity_factor}, where prefill({S_c + 1}) and prefill({S_c}) may drop "
              f"other tokens: {gap:.3g} (printed, not held to the bar)")
    out["consistency_gap"] = gaps


def _family_encode(arch, cfg, params, out):
    """hubert-xlarge: encode FAM_ENCODE frames (cold and warm), one encode
    profiled."""
    import torch

    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.runtime.serve_step import make_prefill_step

    B, S = FAM_ENCODE
    frames = torch.as_tensor(SyntheticStream(DataConfig(seq_len=S, global_batch=B, seed=SEED),
                                             cfg).batch(0)["frames"]).cuda()
    encode = make_prefill_step(cfg)
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = encode(params, {"frames": frames})
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if (tuple(logits.shape) != (B, S, cfg.vocab_size) or caches is not None
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"{arch} encode: logits {tuple(logits.shape)}, caches {caches}")
    out["encode"] = {"B": B, "S": S, "cold_ms": ms[0], "warm_ms": ms[1]}
    print(f"  [families] {arch} encode B={B} S={S} frames -> ({B}, {S}, {cfg.vocab_size}) "
          f"logits: cold {ms[0]:.2f} ms, warm {ms[1]:.2f} ms")
    _one_step_numbers("families", f"{arch} one encode", lambda: encode(params, {"frames": frames}),
                      out["encode"])
    out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()


def _family_train(arch, cfg, out):
    """One warm-up and FAM_TRAIN_TIMED full-width steps under ``TrainConfig()``
    on the stream's batches (hubert: masked-prediction CE over frames)."""
    import torch

    from repro_torch.configs import TrainConfig
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.runtime import train_step as ts

    B, S = FAM_TRAIN[arch]
    tcfg = TrainConfig()
    stream = SyntheticStream(DataConfig(seq_len=S, global_batch=B, seed=SEED), cfg)
    torch.cuda.reset_peak_memory_stats()
    state = ts.init_train_state(SEED, cfg, tcfg, device="cuda")
    step_fn = ts.make_train_step(cfg, tcfg)
    state, warm, first = _timed_train_steps(step_fn, state, stream, 0, 1)
    state, ms, metrics = _timed_train_steps(step_fn, state, stream, 1, FAM_TRAIN_TIMED)
    peak = torch.cuda.max_memory_allocated()
    del state
    if not all(math.isfinite(m[k]) for m in (first, metrics) for k in ("loss", "grad_norm")):
        raise AssertionError(f"{arch} train steps: first {first}, last {metrics}")
    med = statistics.median(ms)
    out["train"] = {"B": B, "S": S, "warmup_ms": warm[0], "ms_steps": ms, "ms_per_step": med,
                    "tokens_per_s": B * S / (med / 1e3), "loss_first": first["loss"],
                    "loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                    "ln_vocab": math.log(cfg.vocab_size), "peak_allocated_bytes": peak}
    print(f"  [families] {arch} train B={B} S={S} (TrainConfig(), remat={cfg.remat}): warm-up "
          f"{warm[0]:.1f} ms, then {[round(x, 1) for x in ms]} ms a step, "
          f"{out['train']['tokens_per_s']:.0f} tokens/s; loss {first['loss']:.4f} at the first "
          f"step (ln V = {math.log(cfg.vocab_size):.2f}), {metrics['loss']:.4f} at step "
          f"{FAM_TRAIN_TIMED + 1}; allocator peak {peak} B ({peak / 2**30:.2f} GiB)")


def _family_full_width(arch, out, calls):
    """One family at full width (scout's depth cut): parameters drawn on the
    card from a seed (the init's allocator peak), then encode or serve, then
    train where FAM_TRAIN says so; everything freed at the end."""
    import torch

    from repro_torch import models

    cfg = _family_config(arch)
    r = out[arch] = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = models.init_params(SEED, cfg, device="cuda")
    torch.cuda.synchronize()
    leaves = _tree_leaves(params)
    r.update(init_s=time.perf_counter() - t0, n_params=sum(t.numel() for t in leaves),
             param_bytes=sum(t.numel() * t.element_size() for t in leaves),
             init_peak_allocated_bytes=torch.cuda.max_memory_allocated(),
             layers=cfg.n_layers, param_dtype=cfg.param_dtype, compute_dtype=cfg.compute_dtype)
    print(f"  [families] {arch}: {cfg.n_layers} layers ({cfg.scan_unit} x {cfg.resolved_units} + "
          f"{cfg.tail}), d_model {cfg.d_model}, vocab {cfg.vocab_size}: {r['n_params']} "
          f"parameters, {r['param_bytes']} B ({cfg.param_dtype}; compute {cfg.compute_dtype}), "
          f"drawn on the card in {r['init_s']:.2f} s, allocator peak "
          f"{r['init_peak_allocated_bytes']} B")
    if arch == "llama4-scout-17b-16e" and r["init_peak_allocated_bytes"] > FAM_INIT_PEAK_LIMIT:
        raise AssertionError(f"scout's init peaked at {r['init_peak_allocated_bytes']} B")
    torch.cuda.reset_peak_memory_stats()
    if cfg.encoder_only:
        _family_encode(arch, cfg, params, r)
    else:
        _family_serve(arch, cfg, params, r, calls)
    print(f"  [families] {arch} allocator peak while serving {r['peak_allocated_bytes']} B "
          f"({r['peak_allocated_bytes'] / 2**30:.2f} GiB)")
    del params, leaves
    _free_card()
    if arch in FAM_TRAIN:
        _family_train(arch, cfg, r)
        _free_card()


def _family_card_vs_cpu(arch):
    """The reduced config, parameters drawn on the CPU and copied to the card:
    the prefill (logits within LM_LOGIT_TOL; hubert: the (B, S, V) encoding)
    and LM_REDUCED_STEPS greedy decode steps (tokens equal); an MoE layer at
    the reduced capacity factor and at MOE_DROP_FACTOR (within
    MOE_SCATTER_TOL); and ``_step_card_vs_cpu`` in f32."""
    import dataclasses

    import torch

    from repro_torch import models
    from repro_torch.configs import TrainConfig, get_bundle, reduced_model
    from repro_torch.data import DataConfig, SyntheticStream
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.runtime import train_step as ts

    red = reduced_model(get_bundle(arch).model)
    B, S = LM_BATCH, 64
    p_cpu = models.init_params(SEED, red, device="cpu")
    p_gpu = _tree_to(p_cpu, "cuda")
    batch = {k: torch.as_tensor(v) for k, v in SyntheticStream(
        DataConfig(seq_len=S, global_batch=B, seed=SEED + 11), red).batch(0).items()}
    gbatch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    lc, cc = models.forward_prefill(p_cpu, batch, red, cache_len=S + 8)
    lg, cg = models.forward_prefill(p_gpu, gbatch, red, cache_len=S + 8)
    worst = float((lg.cpu() - lc).abs().max())
    if not red.encoder_only:
        tc, tg = (torch.argmax(x, -1).to(torch.int32) for x in (lc, lg))
        for i in range(LM_REDUCED_STEPS):
            if not torch.equal(tg.cpu(), tc):
                raise AssertionError(f"reduced {arch}: tokens differ at step {i}")
            pos = torch.full((B,), S + i, dtype=torch.int32)
            lc, tc, cc = models.forward_decode(p_cpu, {"token": tc, "pos": pos}, cc, red)
            lg, tg, cg = models.forward_decode(p_gpu, {"token": tg, "pos": pos.cuda()}, cg, red)
            worst = max(worst, float((lg.cpu() - lc).abs().max()))
        if not torch.equal(tg.cpu(), tc):
            raise AssertionError(f"reduced {arch}: tokens differ after the last step")
    out["logits_err"] = worst
    if worst > LM_LOGIT_TOL:
        raise AssertionError(f"reduced {arch}: logits off by {worst:.3g}")
    what = "the encoding" if red.encoder_only else f"prefill and {LM_REDUCED_STEPS} decode steps"
    print(f"  [families] reduced {arch} (f32) on the card and the CPU, same parameters: {what}, "
          f"logits max_abs_err {worst:.3g} (tolerance {LM_LOGIT_TOL})"
          + ("" if red.encoder_only else ", tokens equal"))
    if red.moe is not None:
        i = next(j for j, k in enumerate(red.scan_unit) if k.endswith("_moe"))
        layer = model_lib._index(p_cpu["units"], 0)[f"p{i}"]["ffn"]
        x = torch.randn((B, S, red.d_model), generator=torch.Generator().manual_seed(SEED + 12))
        T, E = B * S, red.moe.n_experts
        out["moe"] = {}
        for factor in (red.moe.capacity_factor, MOE_DROP_FACTOR):
            c = dataclasses.replace(red, moe=dataclasses.replace(red.moe, capacity_factor=factor))
            want = moe.moe_ffn(layer, x, c, c.moe)
            got = moe.moe_ffn(_tree_to(layer, "cuda"), x.cuda(), c, c.moe).cpu()
            routed = torch.argmax(x.reshape(T, -1) @ layer["router"]["w"], dim=-1)
            C = moe._capacity(T, E, factor)
            dropped = int((torch.bincount(routed, minlength=E) - C).clamp(min=0).sum())
            err = float((got - want).abs().max())
            out["moe"][factor] = {"err": err, "dropped": dropped, "capacity": C}
            print(f"  [families] reduced {arch} MoE layer p{i}, {T} tokens over {E} experts at "
                  f"capacity factor {factor} (C={C}, {dropped} dropped): card vs CPU max_abs_err "
                  f"{err:.3g} (tolerance {MOE_SCATTER_TOL})")
            if not torch.allclose(got, want, rtol=MOE_SCATTER_TOL, atol=MOE_SCATTER_TOL):
                raise AssertionError(f"reduced {arch} MoE layer at capacity {factor}: {err}")
    tcfg = TrainConfig(warmup_steps=2, total_steps=20)
    state = ts.init_train_state(SEED, red, tcfg, device="cpu")
    out["train"] = _step_card_vs_cpu(f"reduced {arch} f32 compute, one step", red, tcfg, state,
                                     batch, tag="families")
    return out


def phase_families_path(card):
    """The other six model families (ROADMAP.md Queue A item 14c), one at a
    time, each freed before the next, with the launch counts zeroed first:

    1. full width (parameters drawn on the card from a seed): hubert-xlarge
       (48 layers, f32, 0.95 B parameters) encodes B=4 x 1024 frames and
       takes FAM_TRAIN_TIMED masked-CE train steps at B=4, S=1024;
       qwen2-vl-2b (1.55 B) prefills B=4 prompts of 256 patches and 64
       tokens (S=320, t = h = w grids), decodes 16 steps plain and with ALSH
       retrieval at ``RetrievalConfig()``, and trains at B=2, S=1024;
       mamba2-2.7b (2.70 B) prefills B=4, S=512 (two SSD chunks), decodes 16
       steps plain and with retrieval, and holds its f32 prefill/decode gap
       at S=512 and S=600 (the pad path) to LM_CONSISTENCY_TOL; zamba2-7b
       (5.62 B) prefills B=4, S=512, decodes 16 steps, gap at S=512;
       llama4-scout-17b-16e with its depth cut from 12 units to
       FAM_SCOUT_UNITS (8 layers, ~19.7 B bf16 parameters; widths, its 16
       experts and capacity factor unchanged; its init's allocator peak
       under FAM_INIT_PEAK_LIMIT) prefills B=4, S=64, decodes 16 steps, gap
       at S=64 with no token dropped (printed at its capacity factor).
       Each: prefill ms, ms a decode step (median of LM_TIMING_LOOPS loops),
       one step's device busy, idle share and ATen ops, allocator peaks;
    2. every family reduced, card against the CPU (``_family_card_vs_cpu``),
       llama4-maverick-400b-a17b included (one of its units, ~33 B
       parameters, does not fit the card beside its embeddings);
    3. after the counts are read: the retrieval decode steps' kernels at
       their captured shapes against their plain versions
       (``_kernels_against_plain``)."""
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    out, calls = {"card": card}, {}
    _free_card()
    _build.reset_launch_counts()
    for arch in ("hubert-xlarge", "qwen2-vl-2b", "mamba2-2.7b", "zamba2-7b",
                 "llama4-scout-17b-16e"):
        t0 = time.perf_counter()
        _family_full_width(arch, out, calls)
        out[arch]["seconds"] = time.perf_counter() - t0
        print(f"  [families] {arch}: {out[arch]['seconds']:.1f} s")
    out["card_vs_cpu"] = {arch: _family_card_vs_cpu(arch) for arch in FAM_REDUCED}
    _path_counts("families", ("alsh_project", "gather_rerank_topk"))
    _kernels_against_plain("families", calls, sealed_f32=True)
    del calls
    _free_card()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [families] phase {out['phase_s']:.1f} s, {card}")
    print(f"  [families] numbers: {json.dumps(out, default=str)}")


MESH_LLAMA4 = ("llama4-scout-17b-16e", "llama4-maverick-400b-a17b")  # train_4k on pod2, --optimized
MESH_FIT_SHARE = 0.95  # of the card's free bytes a one-card cell may be predicted to need
# The caching allocator's rounding: a block is a multiple of 512 bytes, and a
# large one (over 1 MiB) may keep the unsplit rest of its 2 MiB-rounded segment
MESH_ALLOC_ROUND = (512, 2 << 20)
MESH_STEPS = 3  # timed decode steps a one-card cell (after one warm-up)
MESH_MOE = (8, 64)  # (B, S) of the reduced scout's MoE layer on the (2, 4) mesh
MESH_MOE_BAR = 2e-4  # ep_shardmap against gspmd: the reference's bar (tests/test_distributed.py)
MESH_MOE_CPU_TOL = 1e-5  # a2a with drops, the card against the CPU (the scatter tolerance)
MESH_MOE_DROP_FACTOR = 0.5


def _mesh_dryrun(out):
    """``launch.dryrun.run_cell`` for every (arch, shape) on pod1, the
    MESH_LLAMA4 train_4k cells also on pod2 and under ``--optimized`` on
    both, in spawned worker processes (one meta run per (arch, shape,
    config), reused across meshes where nothing changes); one line per cell
    from its record."""
    import os
    import tempfile

    from repro_torch.configs import SHAPES, get_bundle, list_archs
    from repro_torch.launch import dryrun

    workers = max(1, (os.cpu_count() or 3) - 2)  # a core left for the card's phases
    cells = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        plain, opt = os.path.join(tmp, "plain"), os.path.join(tmp, "opt")
        os.makedirs(plain)
        os.makedirs(opt)
        both = ["pod1", "pod2"]
        tasks = [(a, s, both if (a in MESH_LLAMA4 and s == "train_4k") else ["pod1"], plain,
                  False, False) for a in list_archs() for s in SHAPES]
        tasks += [(a, "train_4k", both, opt, False, True) for a in MESH_LLAMA4]
        ok = dryrun.run_groups(tasks, workers=workers)
        for d, optimized in ((plain, False), (opt, True)):
            for name in sorted(os.listdir(d)):
                with open(os.path.join(d, name)) as f:
                    cells[("opt " if optimized else "") + name[:-5]] = json.load(f)
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_workers"] = workers
    n_ok = n_skip = 0
    for key, rec in cells.items():
        if rec["status"] == "skipped":
            n_skip += 1
            print(f"  [mesh] dryrun {key}: skipped ({rec['reason']})")
            continue
        if rec["status"] != "ok":
            raise AssertionError(f"dry-run cell {key}: {rec.get('error')}")
        n_ok += 1
        print(f"  [mesh] dryrun {key}: {rec['argument_size_in_bytes']} argument bytes a device, "
              f"{rec['aten_ops']} aten ops, whole-program live peak (meta) "
              f"{rec['whole_program_live_bytes_peak']} B, meta run {rec['meta_run_s']:.2f} s"
              + (" (reused)" if rec["meta_run_reused"] else ""))
    want = sum(len(get_bundle(a).runnable_shapes()) for a in list_archs()) + 3 * len(MESH_LLAMA4)
    if not ok or n_ok != want:
        raise AssertionError(f"dry run: {n_ok} cells ok of {want}")
    print(f"  [mesh] dry run: {n_ok} cells ok, {n_skip} skipped, in {out['dryrun_s']:.1f} s on "
          f"{workers} worker processes")
    out["dryrun"] = {k: {f: r.get(f) for f in ("status", "argument_size_in_bytes",
                                                 "output_size_in_bytes", "aten_ops",
                                                 "whole_program_live_bytes_peak", "meta_run_s",
                                                 "meta_run_reused")}
                     for k, r in cells.items()}


def _requested_bytes():
    """The bytes the live tensors asked the caching allocator for, before
    its rounding (None where this torch does not count them)."""
    import torch

    return torch.cuda.memory_stats().get("requested_bytes.all.current")


def _mesh_one_card(out):
    """Every (arch, decode shape) whose argument bytes plus its meta run's
    live peak (a lower bound on what the step holds) fit MESH_FIT_SHARE of
    the card's free bytes, on ``make_local_mesh()`` (a (1, 1) mesh of
    cuda:0): real parameters (from a seed) and caches allocated on the card,
    ``memory_allocated`` against the predicted argument bytes, one warm-up
    and MESH_STEPS timed decode steps at the cell's full shape."""
    import torch

    from repro_torch import models
    from repro_torch.configs import SHAPES, get_bundle, list_archs
    from repro_torch.launch import compile as lc
    from repro_torch.launch import specs as input_specs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.runtime.serve_step import make_decode_step

    mesh = make_local_mesh()
    if mesh.shape != {"data": 1, "model": 1}:
        raise AssertionError(f"make_local_mesh() on one card: {mesh}")
    res = out["one_card"] = {}
    for arch in list_archs():
        bundle = get_bundle(arch)
        for name in ("decode_32k", "long_500k"):
            if name in bundle.shape_skips:
                continue
            shape, cfg = SHAPES[name], bundle.model
            cell = lc.lower_cell(bundle, shape, mesh)
            _free_card()
            free = torch.cuda.mem_get_info()[0]
            need = cell.argument_size_in_bytes + cell.whole_program_live_bytes_peak
            if need > MESH_FIT_SHARE * free:
                print(f"  [mesh] one card {arch} x {name}: predicted {need} B (arguments "
                      f"{cell.argument_size_in_bytes} + live peak "
                      f"{cell.whole_program_live_bytes_peak}) > {MESH_FIT_SHARE} of {free} "
                      f"free: not run")
                continue
            r = res[f"{arch} x {name}"] = {"predicted_argument_bytes": cell.argument_size_in_bytes,
                                           "predicted_live_peak": cell.whole_program_live_bytes_peak,
                                           "free_bytes": free}
            base = torch.cuda.memory_allocated()
            base_req = _requested_bytes()
            torch.cuda.reset_peak_memory_stats()
            params = models.init_params(SEED, cfg, device="cuda")
            caches = models.init_caches(shape.global_batch, shape.seq_len, cfg, device="cuda")
            batch = input_specs.decode_batch(cfg, shape.global_batch, shape.seq_len - 1,
                                             concrete=True, device="cuda")
            torch.cuda.synchronize()
            leaves = _tree_leaves((params, batch, caches))
            got = torch.cuda.memory_allocated() - base
            requested = None if base_req is None else _requested_bytes() - base_req
            rounding = sum(MESH_ALLOC_ROUND[t.numel() * t.element_size() > 1 << 20]
                           for t in leaves)
            r.update(allocated_bytes=got, requested_bytes=requested, leaves=len(leaves))
            if not 0 <= got - cell.argument_size_in_bytes <= rounding or requested not in (
                    None, cell.argument_size_in_bytes):
                raise AssertionError(f"{arch} x {name}: {got} B allocated ({requested} "
                                     f"requested), {cell.argument_size_in_bytes} predicted")
            step = make_decode_step(cfg)
            # the warm-up step from an emptied cache, so the timed steps reuse
            # the blocks it made (with blocks cached from the set-up in play,
            # the second mamba2-2.7b decode_32k step found no room for its 20
            # GiB stacked cache)
            _free_card()
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad():
                logits, tok, new = step(params, batch, caches)
                del new
                torch.cuda.synchronize()
                r["step_peak_bytes"] = torch.cuda.max_memory_allocated() - base
                ms = []
                for _ in range(MESH_STEPS):
                    t = time.perf_counter()
                    new = step(params, batch, caches)[2]
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                    del new
            if logits.shape != (shape.global_batch, cfg.vocab_size) or not bool(
                    torch.isfinite(logits).all()):
                raise AssertionError(f"{arch} x {name}: logits {tuple(logits.shape)} not finite")
            r.update(ms=ms, ms_median=statistics.median(ms),
                     peak_allocated_bytes=torch.cuda.max_memory_allocated() - base)
            print(f"  [mesh] one card {arch} x {name} (B={shape.global_batch}, cache "
                  f"{shape.seq_len}): predicted argument bytes {cell.argument_size_in_bytes}, "
                  f"requested {requested}, allocated {got} ({len(leaves)} tensors); live peak "
                  f"(meta) "
                  f"{cell.whole_program_live_bytes_peak} B; allocator peak over the arguments "
                  f"{r['step_peak_bytes'] - got} B in a step ({r['peak_allocated_bytes']} B in "
                  f"all); {r['ms_median']:.2f} ms a decode step (median of {MESH_STEPS}: "
                  f"{', '.join(f'{m:.2f}' for m in ms)})")
            del params, caches, batch, logits, tok, leaves
            _free_card()
    if not res:
        raise AssertionError("no decode cell was predicted to fit the card")


def _mesh_moe(out):
    """The reduced llama4-scout's MoE layer on a (2, 4) ("data", "model")
    mesh of [cuda:0] * 8: ep_shardmap (megatron and dp_over_model layouts)
    against ``moe_ffn_gspmd`` at its capacity factor (>= T: nothing drops)
    within MESH_MOE_BAR; a2a_shardmap at MESH_MOE_DROP_FACTOR (tokens drop)
    against the same impl on the CPU within MESH_MOE_CPU_TOL; every gradient
    of both finite."""
    import dataclasses

    import torch

    from repro_torch.configs import get_bundle, reduced_model
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe, sharding

    red = reduced_model(get_bundle("llama4-scout-17b-16e").model)
    gen = torch.Generator().manual_seed(SEED + 13)
    layer = moe.init_moe(gen, red, red.moe, torch.float32)
    B, S = MESH_MOE
    x = torch.randn((B, S, red.d_model), generator=gen)
    card = make_local_mesh(2, 4, devices=[torch.device("cuda", 0)] * 8)
    cpu = make_local_mesh(2, 4, devices=[torch.device("cpu")] * 8)
    res = out["moe"] = {}

    def run(impl, cfg, mesh, params, xin, dp):
        live = {k: v for k, v in _tree_to(params, xin.device).items()}
        leaves = [t.requires_grad_() for t in _tree_leaves(live)]
        xg = xin.clone().requires_grad_()
        sharding.set_policy(dp_over_model=dp)
        try:
            with sharding.use_mesh(mesh):
                y = getattr(moe, f"moe_ffn_{impl}")(live, xg, cfg, cfg.moe)
        finally:
            sharding.set_policy()
        grads = torch.autograd.grad(y.sum(), [xg, *leaves])
        if not all(bool(torch.isfinite(g).all()) for g in grads):
            raise AssertionError(f"{impl}: a gradient is not finite")
        return y.detach(), grads

    want = moe.moe_ffn_gspmd(_tree_to(layer, "cuda"), x.cuda(), red, red.moe)
    for dp in (False, True):
        y, _ = run("ep_shardmap", red, card, layer, x.cuda(), dp)
        err = float((y - want).abs().max())
        res[f"ep_shardmap dp_over_model={dp}"] = err
        print(f"  [mesh] MoE ep_shardmap on the card's (2, 4) mesh (dp_over_model={dp}), "
              f"{B * S} tokens over {red.moe.n_experts} experts: max_abs_err against gspmd "
              f"{err:.3g} (bar {MESH_MOE_BAR}); grads finite")
        if not torch.allclose(y, want, rtol=MESH_MOE_BAR, atol=MESH_MOE_BAR):
            raise AssertionError(f"ep_shardmap against gspmd: {err}")
    drop = dataclasses.replace(red, moe=dataclasses.replace(red.moe,
                                                            capacity_factor=MESH_MOE_DROP_FACTOR))
    y_card, _ = run("a2a_shardmap", drop, card, layer, x.cuda(), True)
    y_cpu, _ = run("a2a_shardmap", drop, cpu, layer, x, True)
    routed_cpu = y_cpu - moe.mlp.mlp(layer["shared"], x.reshape(B * S, -1), "swiglu").reshape(
        B, S, -1)
    dropped = int((routed_cpu.abs().amax(dim=-1) == 0).sum())
    err = float((y_card.cpu() - y_cpu).abs().max())
    res["a2a_shardmap drops"] = {"err": err, "tokens_without_routed_output": dropped}
    print(f"  [mesh] MoE a2a_shardmap at capacity factor {MESH_MOE_DROP_FACTOR} "
          f"({dropped} of {B * S} tokens without a routed output): card vs CPU max_abs_err "
          f"{err:.3g} (tolerance {MESH_MOE_CPU_TOL}); grads finite")
    if dropped == 0 or not torch.allclose(y_card.cpu(), y_cpu, rtol=MESH_MOE_CPU_TOL,
                                          atol=MESH_MOE_CPU_TOL):
        raise AssertionError(f"a2a_shardmap: card vs CPU {err}, {dropped} dropped")


def phase_mesh_path(card):
    """The mesh and dry-run tooling (ROADMAP.md Queue A item 14d):

    a. the dry run (``_mesh_dryrun``): every runnable (arch x shape) of the
       ten archs on the abstract pod1 mesh, and the llama4 train_4k cells on
       pod2 and under ``--optimized`` (a2a_shardmap on the (16, 16) mesh),
       each ok or skipped with its bundle's reason; its worker processes run
       on the host's cores while (b) and (c) run on the card;
    b. one card (``_mesh_one_card``): the decode cells predicted to fit,
       allocated and stepped on a (1, 1) mesh of cuda:0, the allocator
       beside the prediction;
    c. the MoE mesh impls on a (2, 4) mesh of the card (``_mesh_moe``).

    No kernel of the port runs on this path: its launch counts, zeroed
    first and read last, must all be 0 (the dry run's workers are processes
    of their own, on meta tensors)."""
    import concurrent.futures

    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    out = {"card": card}
    _free_card()
    _build.reset_launch_counts()
    with concurrent.futures.ThreadPoolExecutor(1) as waiter:
        dry = waiter.submit(_mesh_dryrun, out)
        _mesh_one_card(out)
        _mesh_moe(out)
        dry.result()
    counts = _path_counts("mesh", ())
    if any(counts.values()):
        raise AssertionError(f"the mesh path launched a kernel: {counts}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  [mesh] phase {out['phase_s']:.1f} s, {card}")
    print(f"  [mesh] numbers: {json.dumps(out, default=str)}")


def phase_small_check():
    """The card's answers against the plain PyTorch path on the CPU, over
    one index state (built on the card, copied to the CPU)."""
    import dataclasses

    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.kernels.ref import unexplained_id_mismatches

    cfg = tapi.IndexConfig(d=128, M=32, K=12, L=32, max_candidates=128,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    wl = workload(8192, 128, seed=SEED + 7)
    q, w = (t.cpu() for t in wl.batch(64, SEED + 8))
    data = wl.rows.cpu()
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
    svc = run.phase("service set-up (SERVICE workload, f32 theta index)", Service)
    if svc is None:
        print(f"chip_smoke: FAILED phases: {run.failures}")
        return 1
    card = dev["card"]
    run.phase("path (SERVICE, theta + l2)", phase_main_path, svc)
    run.phase("path (SERVICE, int8 and bf16 storage, screen alpha 2 and 0)", phase_quant_path,
              svc)
    run.phase("path (SERVICE, theta multiprobe)", phase_multiprobe_path, svc)
    run.phase("path (SERVICE, stream: insert, delete, two-segment query, compact)",
              phase_stream_path, svc)
    run.phase("path (SERVICE, early exit: streamed query, explain, serve --stats)",
              phase_early_exit_path, svc)
    run.phase("path (SERVICE, persistence: save, load, query)", phase_persist_path, svc, card)
    run.phase("path (SERVICE, quality-first planning and the offline tuner)", phase_plan_path,
              svc, card)
    run.phase("path (SERVICE, the serving broker: ladder, traces, shard chaos)",
              phase_broker_path, svc, card)
    run.phase("path (SERVICE x8 shards, sharded)", phase_sharded_path, svc, card)
    run.phase("path (static_contracts: lint, the audit lattice, seeded regressions, SERVICE "
              "peak bytes and syncs)", phase_static_contracts, svc, card)
    run.phase("path (lm: full-width gemma3-1b, prefill and decode, plain, with ALSH retrieval "
              "and a growing datastore)", phase_lm_path, card)
    run.phase("path (train: full-width gemma3-1b at S=4096, card vs CPU, restart drill, "
              "pipeline)", phase_train_path, card)
    run.phase("path (families: hubert-xlarge, qwen2-vl-2b, mamba2-2.7b, zamba2-7b, llama4-scout "
              "cut to 2 units at full width; all six reduced, card vs CPU)",
              phase_families_path, card)
    run.phase("path (mesh: the dry run of every cell, decode cells on one card, the MoE mesh "
              "impls on a (2, 4) mesh of the card)", phase_mesh_path, card)
    run.phase("check against the CPU path", phase_small_check)
    if run.failures:
        print(f"chip_smoke: FAILED phases: {run.failures}")
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": dev["kind"],
                                             "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
