"""Fan-out scan executor with a crash-safe incremental trial store —
counterpart of ``repro.tuner.scan``.

One trial builds an index at a concrete :class:`~repro_torch.tuner.space.
TrialSpec` point and measures, through the real ``Index.query`` path on
``device`` (default: the CUDA card, where the probe runs the hand kernels
and the oracle ``wl1_scan_topk``):

  * ``recall``     — held-out recall@k against the exact oracle
  * ``cand_frac``  — mean unique candidates / n (the sublinearity metric)
  * ``cost``       — the planner's deterministic candidate+slot cost model
                     (the latency axis of the Pareto table)
  * ``mem_bytes``  — bytes of the built index state (the reference's leaves)
  * ``us_per_query`` — wall time per query (advisory: median of 3 warm
                     calls, after ``torch.cuda.synchronize`` on the card;
                     left out of the frontier, which stays reproducible)

``workers > 1`` fans the trials out over a ``spawn`` pool (fresh
interpreters, each with its own CUDA context; the parent builds the kernels
first so no worker runs ``nvcc``; each worker's kernel launches are added to
the parent's launch counts); only picklable dicts cross the pool. A
trial with ``shards > 1`` runs on a ``ShardedIndex`` over the first
``shards`` devices of the trial's kind (the CPU counts as one device, CUDA
as every card), and is recorded with ``status="skipped"`` and the
reference's reason when the host has fewer.

The JSONL trial store holds one fsync'd line per completed trial, keyed by
the content-addressed ``trial_id``. A resume re-enumerates the space, skips
every stored id, tolerates a torn trailing line and refuses interior
corruption and a store written for another space. Per-trial seeds derive
from the trial ids, so a finished grid is the same however often the scan
died on the way. The store's format is the reference's.
"""

from __future__ import annotations

import json
import os
import time

import torch

from repro_torch.tuner.space import (
    AUTO_WIDTH,
    ScanSpace,
    TrialSpec,
    profile_data,
    profile_queries,
    profile_weights,
)

__all__ = ["TrialStore", "run_trial", "run_scan", "resolve_width", "scan_is_complete",
           "trial_cost"]

# relative cost of a probed (table, probe, slot) vs one reranked candidate —
# mirrors Planner.slot_cost so scan costs and plan costs rank identically
SLOT_COST = 0.02


def trial_cost(
    L: int,
    n_probes: int,
    window: int,
    mean_cand: float,
    mean_tables: float | None = None,
) -> float:
    """The deterministic latency proxy of Pareto dominance: candidates plus
    charged probe slots; with ``mean_tables`` (an early-exit trial's mean
    windows visited) only that share of the L·n_probes lattice is charged."""
    slots = float(L * n_probes * window)
    if mean_tables is not None:
        slots *= min(1.0, float(mean_tables) / float(L * n_probes))
    return float(mean_cand) + SLOT_COST * slots


def _width_sample(trial: TrialSpec, data: torch.Tensor, generator: torch.Generator, t: float):
    """``resolve_width``'s sample on ``data``'s device: data rows jittered by
    one lattice cell, with profile weights."""
    m = min(trial.queries, trial.profile.n)
    d = trial.profile.d
    rows = torch.randperm(data.shape[0], generator=generator)[:m]
    jit = torch.rand((m, d), generator=generator) * (2.0 / t) - 1.0 / t
    ws = profile_weights(generator, (m, d), trial.profile.skew)
    dev = data.device
    return data[rows.to(dev)] + jit.to(dev), ws.to(dev)


def resolve_width(trial: TrialSpec, data: torch.Tensor, generator: torch.Generator) -> float:
    """Resolve ``W="auto"`` for an l2 trial: the bucket width anchored at
    the planner's collision-prob goal on the 75th percentile of the
    transformed kth-NN near distance (``Planner._solve_family``'s rule, on
    the trial's own data; the exact scan runs ``ops.wl1_scan_topk``)."""
    from repro_torch.api.planner import Planner, quantile_f32
    from repro_torch.core import theory, transforms
    from repro_torch.core.transforms import BoundedSpace
    from repro_torch.kernels import ops

    space = BoundedSpace(0.0, 1.0, float(trial.M))
    qs, ws = _width_sample(trial, data, generator, space.t)
    levels = transforms.discretize(data, space).to(torch.float32).contiguous()
    qlevels = transforms.discretize(qs, space).to(torch.float32).contiguous()
    kk = min(trial.k + 1, data.shape[0])
    nn_d, _ = ops.wl1_scan_topk(levels, qlevels, ws.contiguous(), kk)
    r1 = torch.clamp(nn_d[:, kk - 1], min=1e-6)
    s1 = theory.l2_distance_from_wl1(r1, max(space.M, 1), trial.profile.d, ws)
    c_star = 1.0 / theory.invert_p_l2(Planner._P1_GOAL, 1.0)
    return float(c_star * quantile_f32(s1, 0.75))


def _trial_index(generator: torch.Generator, data: torch.Tensor, cfg, device):
    """The trial's index, its tables drawn from ``generator``."""
    from repro_torch.api import Index

    return Index.build(generator, data, cfg, device=device)


def _host_devices(dev) -> list:
    """The host's devices of ``dev``'s kind: every CUDA card, or the CPU
    as one device."""
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _state_bytes(state) -> int:
    """Bytes of the reference's ``ALSHIndex`` leaves (the card's table
    relayout ``tables.tiled`` is not one)."""
    leaves = [state.tables.folded, state.tables.offsets, state.mixers, state.sorted_keys,
              state.perm, state.data, state.levels, state.scales]
    return int(sum(t.nbytes for t in leaves if t is not None))


def run_trial(trial_dict: dict, real_data=None, device=None) -> dict:
    """Execute one trial on ``device`` (default: the CUDA card); returns
    the store record (a plain JSON dict). Deterministic given the trial
    content, but for the advisory ``us_per_query``. A module-level function,
    so a spawn pool can pickle it."""
    from repro_torch.api import IndexConfig, PlannedSpec, QuerySpec
    from repro_torch.api.index import resolve_device
    from repro_torch.api.planner import mean_f32, seeded_generator
    from repro_torch.core.distributed import make_mesh
    from repro_torch.core.transforms import BoundedSpace
    from repro_torch.distance import recall_at_k

    trial = TrialSpec.from_dict(trial_dict)
    rec = {"trial_id": trial.trial_id, "trial": trial.to_dict(), "status": "ok"}
    dev = resolve_device(device)
    devices = _host_devices(dev)
    if trial.shards > 1 and len(devices) < trial.shards:
        rec.update(
            status="skipped",
            reason=f"needs {trial.shards} devices, host has {len(devices)}",
        )
        return rec

    # one CPU generator per draw: 0 data, 1 width sample, 2 tables, 3 queries, 4 weights
    gens = [seeded_generator(trial.seed, i) for i in range(5)]
    data = profile_data(trial.profile, gens[0], real_data, device=dev)
    W = trial.W
    if W == AUTO_WIDTH:
        W = resolve_width(trial, data, gens[1]) if trial.family == "l2" else 4.0
    cfg = IndexConfig(
        d=trial.profile.d, M=trial.M, K=trial.K, L=trial.L,
        family=trial.family, W=float(W), max_candidates=trial.window,
        space=BoundedSpace(0.0, 1.0, float(trial.M)),
    )
    index = _trial_index(gens[2], data, cfg, dev)
    qs = profile_queries(trial.profile, gens[3], trial.queries, real_data, device=dev)
    ws = profile_weights(gens[4], (trial.queries, trial.profile.d), trial.profile.skew,
                         device=dev)
    spec = PlannedSpec(
        k=trial.k, mode="multiprobe" if trial.n_probes > 1 else "probe",
        n_probes=trial.n_probes if trial.n_probes > 1 else 1,
        max_flips=trial.max_flips, max_candidates=trial.window,
        early_exit=trial.early_exit, exit_group=trial.exit_group,
        exit_slack=trial.exit_slack,
    )
    handle = index
    if trial.shards > 1:
        handle = index.shard(make_mesh((trial.shards,), ("data",),
                                       devices=devices[: trial.shards]))
    res = handle.query(qs, ws, spec)
    exact = handle.query(qs, ws, QuerySpec(k=trial.k, mode="exact"))
    recall = float(recall_at_k(res.ids, exact.ids, trial.k))
    mean_cand = mean_f32(res.n_candidates)
    # a sharded answer (ShardedQueryResult) carries no tables_probed
    tables = getattr(res, "tables_probed", None)
    mean_tables = mean_f32(tables) if tables is not None else None

    # advisory wall time: median of 3 warm calls
    times = []
    for _ in range(3):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        handle.query(qs, ws, spec)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    times.sort()

    rec.update(
        family=trial.family, K=trial.K, L=trial.L, W=float(W),
        n_probes=trial.n_probes, max_flips=trial.max_flips,
        window=trial.window, k=trial.k, shards=trial.shards,
        early_exit=trial.early_exit, exit_group=trial.exit_group,
        exit_slack=trial.exit_slack,
        tables_probed=mean_tables,
        recall=recall,
        cand_frac=mean_cand / trial.profile.n,
        cost=trial_cost(trial.L, trial.n_probes, trial.window, mean_cand, mean_tables),
        mem_bytes=_state_bytes(index.state),
        us_per_query=times[1] / trial.queries * 1e6,
    )
    return rec


def _pool_trial(args) -> tuple[dict, dict]:
    """One trial in a spawned worker: its record and the kernel launches it
    made there (the parent adds them to its own counts)."""
    from repro_torch.kernels import _build

    trial_dict, real, device = args
    _build.reset_launch_counts()
    rec = run_trial(trial_dict, real_data=real, device=device)
    return rec, _build.launch_counts()


class TrialStore:
    """Append-only JSONL store of completed trial records.

    Line 0 is a header naming the :class:`ScanSpace` content hash; every
    following line is one completed trial. Writes are flushed + fsync'd per
    record, so a kill between trials loses nothing and a kill mid-write
    leaves at most one torn TRAILING line, which ``load`` tolerates. A torn
    or alien line anywhere else means the store is corrupt (or belongs to a
    different scan) and raises a named error instead of silently merging.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def has_data(self) -> bool:
        return self.exists() and os.path.getsize(self.path) > 0

    def repair(self) -> None:
        """Truncate a torn TRAILING line (the mid-write crash artifact).
        Run before resuming appends: left in place, the torn line would sit
        ABOVE the resumed records and read as interior corruption on the
        next load."""
        if not self.exists():
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        while lines and not lines[-1].strip():
            lines.pop()
        if not lines:
            return
        try:
            json.loads(lines[-1])
            return  # intact store, nothing to do
        except json.JSONDecodeError:
            pass
        keep = b"\n".join(lines[:-1])
        with open(self.path, "wb") as f:
            if keep:
                f.write(keep + b"\n")
            f.flush()
            os.fsync(f.fileno())

    def write_header(self, space: ScanSpace) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "w") as f:
            f.write(json.dumps(
                {"kind": "space", "space_id": space.space_id}, sort_keys=True
            ) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def load(self, space: ScanSpace | None = None) -> dict:
        """Parse the store into ``{trial_id: record}`` (first write wins —
        duplicate ids cannot disagree, they are content-addressed). Checks
        the header against ``space`` when given."""
        records: dict = {}
        if not self.exists():
            return records
        with open(self.path) as f:
            lines = f.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    continue  # torn trailing line from a mid-write crash
                raise ValueError(
                    f"{self.path}:{i + 1} is not valid JSON (and is not the "
                    f"trailing line) — the trial store is corrupt; delete it "
                    f"to rescan from scratch"
                ) from None
            if i == 0:
                if rec.get("kind") != "space":
                    raise ValueError(
                        f"{self.path} has no space header — not a tuner "
                        f"trial store"
                    )
                if space is not None and rec.get("space_id") != space.space_id:
                    raise ValueError(
                        f"{self.path} was written for scan space "
                        f"{rec.get('space_id')!r} but this scan is "
                        f"{space.space_id!r} — point the scan at a fresh "
                        f"store (mixing spaces would corrupt the frontier)"
                    )
                continue
            records.setdefault(rec["trial_id"], rec)
        return records

    def append(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record, sort_keys=True) + "\n")
            f.flush()
            os.fsync(f.fileno())


def run_scan(
    space: ScanSpace,
    store_path: str | os.PathLike,
    workers: int = 0,
    real_data=None,
    max_trials: int | None = None,
    log=None,
    device=None,
) -> list:
    """Run (or resume) the scan on ``device`` (default: the CUDA card);
    returns the completed records in canonical trial order.

    Args:
      space: the declarative grid to cover.
      store_path: JSONL trial store — created with a space header if absent,
        resumed (completed ids skipped) if present.
      workers: 0/1 runs trials inline; N > 1 fans out over N spawned worker
        processes (each with its own CUDA context).
      real_data: (rows, d) array backing ``source="sampled"`` profiles.
      max_trials: stop after this many NEW completions; None runs the grid
        dry.
      log: optional ``print``-like progress callback.
    """
    from repro_torch.api.index import resolve_device

    trials = space.trials()
    store = TrialStore(store_path)
    store.repair()  # drop a torn trailing line before appending below it
    done = store.load(space)
    unknown = set(done) - {t.trial_id for t in trials}
    if unknown:
        raise ValueError(
            f"{store.path} holds {len(unknown)} trial(s) not in this scan "
            f"space (e.g. {sorted(unknown)[:3]}) despite a matching header — "
            f"the store is corrupt; delete it to rescan"
        )
    if not store.has_data():
        store.write_header(space)
    pending = [t for t in trials if t.trial_id not in done]
    if max_trials is not None:
        pending = pending[: max(0, max_trials)]
    if log:
        log(
            f"scan {space.space_id}: {len(trials)} trials total, "
            f"{len(done)} stored, {len(pending)} to run "
            f"(workers={workers})"
        )

    if pending:
        dev = str(resolve_device(device))
        real = None
        if real_data is not None:
            import numpy as np

            real = np.asarray(real_data)
        if workers <= 1:
            for t in pending:
                rec = run_trial(t.to_dict(), real_data=real, device=dev)
                done[rec["trial_id"]] = rec
                store.append(rec)
                if log:
                    log(f"  trial {rec['trial_id']} {rec['status']}")
        else:
            import multiprocessing as mp

            from repro_torch.kernels import _build

            if dev.startswith("cuda"):
                _build.build_all()  # one nvcc per source here, none in the workers
            ctx = mp.get_context("spawn")  # fresh interpreters: a CUDA context each
            with ctx.Pool(processes=workers) as pool:
                jobs = [(t.to_dict(), real, dev) for t in pending]
                for rec, launches in pool.imap_unordered(_pool_trial, jobs):
                    _build.add_launch_counts(launches)
                    done[rec["trial_id"]] = rec
                    store.append(rec)
                    if log:
                        log(f"  trial {rec['trial_id']} {rec['status']}")
    return [done[t.trial_id] for t in trials if t.trial_id in done]


def scan_is_complete(space: ScanSpace, store_path: str | os.PathLike) -> bool:
    """True when every trial of ``space`` has a stored record."""
    done = TrialStore(store_path).load(space)
    return all(t.trial_id in done for t in space.trials())
