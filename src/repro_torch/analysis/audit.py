"""Layer 2 of the static-contract gate: the lattice audit — counterpart of
``repro.analysis.audit``, over the same lattice, budgets and codes.

The public query entry-point lattice — mode (probe / multiprobe / exact) ×
view (sealed / segmented) × storage codec (f32 / bf16 / int8) × screen-α ×
ladder rungs (probe windows, probe counts) × early-exit knobs
(early_exit / exit_group / exit_slack) — runs through the real
:func:`repro_torch.engine.pipeline.query`, and the declared budgets of
:mod:`repro_torch.analysis.budgets` are checked:

  * compile-key cardinality after
    :func:`repro_torch.engine.pipeline.normalize_static_args` vs
    ``RETRACE_BUDGET`` (AUD002) — the raw lattice carries the redundant
    static axes callers may pass, so a normalization gap shows up as extra
    keys;
  * peak live bytes per path vs ``MEMORY_ENVELOPE_BYTES`` (AUD001), from a
    ``TorchDispatchMode`` (:class:`Tracker`) that charges every tensor an
    aten op returns — meta tensors included — until its storage dies;
  * the dtype contract (AUD003): no float64 tensor into or out of any op,
    int8 tensors only into ``INT8_ALLOWED_OPS`` (movement + decode);
  * per-path drift against the golden of the backend (AUD004).

**The one difference from the reference's gate.** The reference traces
every point with ``jax.make_jaxpr`` and executes nothing. The port has no
tracer that survives its data-dependent steps — the searchsorted windows,
the ``nonzero`` of validation, the streamed tail's host loop — so this
audit EXECUTES every point once, at the audit geometry, over four indexes
built once per run (as the reference's fixture builds them). Its bytes
are therefore what the run allocated, not a liveness model of a program:
exact for the inputs used, and per backend (on the card the kernels'
outputs replace the plain versions' intermediates). Launches through
``ctypes`` are invisible to the dispatch mode, so on the card each path
also records the kernels it launched (``_build.launch_counts``) and, for
int8 storage, the stored-type gathers the int8 rows went into.

A live normalization probe runs the reference's denormalized variants on
a tiny index under a :class:`~repro_torch.analysis.retrace_guard.RetraceGuard`:
each must answer bit for bit as its normalized twin, with the same
launches, and build or load no kernel library.

``run_audit(inject=...)`` seeds two regressions to test the gate itself
(``python -m repro_torch.analysis --seed-regression ...``): ``"memory"``
adds the reference's dense (b, L·P·C, cap) f32 delta-match tensor, as a
meta tensor, to every segmented path; ``"retrace"`` counts compile keys
WITHOUT the normalization, as if the engine forgot to fold a static axis.
"""

from __future__ import annotations

import dataclasses
import json
import weakref
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis import budgets
from repro_torch.analysis.retrace_guard import RetraceGuard
from repro_torch.kernels import _build

# audit failure codes (stable, named in reports and CI logs)
AUDIT_CODES = {
    "AUD001": "memory-envelope breach",
    "AUD002": "retrace-budget breach",
    "AUD003": "dtype-contract violation",
    "AUD004": "golden-budget drift",
}

# The kernels that take a table in its stored dtype (the others require f32).
STORED_KERNELS = ("gather_rerank_topk_blocked", "gather_rerank_topk_blocked_two_seg")


@dataclasses.dataclass(frozen=True)
class AuditPoint:
    """One RAW caller combination of the entry-point lattice."""

    family: str
    storage: str
    view: str  # "sealed" | "segmented"
    mode: str
    window: int  # effective max_candidates (ladder rung)
    n_probes: int
    max_flips: int
    impl: str
    screen_alpha: float
    early_exit: bool = False
    exit_group: int = 0
    exit_slack: float = 0.0

    @property
    def name(self) -> str:
        parts = [self.family, self.storage, self.view, self.mode]
        if self.mode != "exact":
            parts.append(f"w{self.window}")
        if self.mode == "multiprobe":
            parts.append(f"p{self.n_probes}")
        if self.screen_alpha:
            parts.append(f"a{int(self.screen_alpha)}")
        if self.early_exit:
            parts.append(f"e{self.exit_group}")
        return "/".join(parts)


@dataclasses.dataclass(frozen=True)
class AuditFailure:
    code: str
    path: str
    message: str
    measured: float
    budget: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"{self.code} [{AUDIT_CODES[self.code]}] {self.path}: "
            f"{self.message} (measured {self.measured:g} vs budget {self.budget:g})"
        )


def _audit_config(family: str, storage: str, window: Optional[int] = None):
    from repro_torch.core.index import IndexConfig

    g = budgets.AUDIT_GEOMETRY
    return IndexConfig(
        d=g["d"],
        M=g["M"],
        K=g["K"],
        L=g["L"],
        family=family,
        W=g["W"],
        max_candidates=window or g["max_candidates"],
        storage=storage,
    )


# (family, storage) combos audited. theta carries the full codec axis;
# l2 pins the family-specific paths (its keys, W bucketing).
AUDIT_BUILDS = (("theta", "f32"), ("theta", "bf16"), ("theta", "int8"), ("l2", "f32"))


def build_audit_indexes(device) -> dict:
    """One mutable index (empty delta of the audit capacity) per audited
    (family, storage), on ``device``, over uniform rows from seed 0."""
    from repro_torch.api.index import Index
    from repro_torch.api.spec import UpdateSpec

    g = budgets.AUDIT_GEOMETRY
    data = torch.rand((g["n"], g["d"]), generator=torch.Generator().manual_seed(0))
    return {
        (family, storage): Index.build(
            0, data, _audit_config(family, storage),
            update=UpdateSpec(delta_capacity=g["delta_capacity"]), device=device,
        )
        for family, storage in AUDIT_BUILDS
    }


def enumerate_points() -> list:
    """The RAW lattice: every caller combination the facades, legacy
    shims, and planner ladder rungs can reach — including the static
    values the engine's normalization must fold away. The reference's
    points, in its order."""
    g = budgets.AUDIT_GEOMETRY
    full_w = g["max_candidates"]
    rung_w = full_w // 2
    points = []
    for family, storage in AUDIT_BUILDS:
        alphas = (0.0,) if storage == "f32" else (0.0, 2.0)
        for view in ("sealed", "segmented"):
            # probe: window rungs × redundant n_probes axis (must fold)
            for window in (full_w, rung_w):
                for n_probes in (1, 8):  # ignored by probe mode
                    for alpha in alphas:
                        points.append(
                            AuditPoint(family, storage, view, "probe", window,
                                       n_probes, 0, "auto", alpha)
                        )
            # multiprobe: probe-count rungs × redundant impl axis (must
            # fold). theta-only — l2 has no perturbation sequence.
            for n_probes in (8, 4) if family == "theta" else ():
                for impl in ("auto", "gather"):  # non-probe impl is folded
                    for alpha in alphas:
                        points.append(
                            AuditPoint(family, storage, view, "multiprobe", full_w,
                                       n_probes, 3, impl, alpha)
                        )
            # exact: window + α must both fold (cfg drops entirely)
            for window in (full_w, rung_w):
                points.append(
                    AuditPoint(family, storage, view, "exact", window, 8, 3,
                               "auto", alphas[-1])
                )
            # early exit — one GENUINE streamed program per mode (probe
            # G=4 over L=8 windows; theta multiprobe G=8 over 8·8), plus
            # the fold axes: knobs with early off fold to the baseline
            # program, a group covering the whole lattice IS the baseline
            # program, early over an active screen folds to the screened
            # program, and early on exact folds entirely.
            points.append(
                AuditPoint(family, storage, view, "probe", full_w, 1, 0,
                           "auto", 0.0, True, 4, 0.1)
            )
            points.append(  # knobs ignored while early_exit=False
                AuditPoint(family, storage, view, "probe", full_w, 1, 0,
                           "auto", 0.0, False, 16, 0.5)
            )
            points.append(  # exit_group >= L·P — single group, must fold
                AuditPoint(family, storage, view, "probe", full_w, 1, 0,
                           "auto", 0.0, True, g["L"], 0.1)
            )
            if family == "theta":
                points.append(
                    AuditPoint(family, storage, view, "multiprobe", full_w,
                               8, 3, "auto", 0.0, True, 8, 0.1)
                )
            if alphas[-1] > 0.0:  # streaming under an active screen folds
                points.append(
                    AuditPoint(family, storage, view, "probe", full_w, 1, 0,
                               "auto", alphas[-1], True, 4, 0.1)
                )
            points.append(  # early on exact folds with everything else
                AuditPoint(family, storage, view, "exact", full_w, 8, 3,
                           "auto", alphas[-1], True, 4, 0.1)
            )
    return points


def _view_args(index, view: str):
    if view == "segmented":
        return index.state, index.delta, index.tombstones
    return index.state, None, None


def _shape_signature(x):
    """What a program keyed on its inputs sees of them: every tensor's shape
    and dtype, in the structure of the dataclasses that hold them."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), str(x.dtype))
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, tuple(
            (f.name, _shape_signature(getattr(x, f.name))) for f in dataclasses.fields(x)
        ))
    if isinstance(x, (tuple, list)):
        return tuple(_shape_signature(v) for v in x)
    return None if x is None else type(x).__name__


def compile_key(point: AuditPoint, index, queries, weights, normalized: bool = True):
    """The key a program cache would see for a call at this lattice point:
    the shape and dtype signature of the tensors plus the (normalized)
    static tuple."""
    from repro_torch.engine import pipeline

    g = budgets.AUDIT_GEOMETRY
    cfg = _audit_config(point.family, point.storage, point.window)
    state, delta, tomb = _view_args(index, point.view)
    statics = (
        cfg, g["k"], point.mode, point.n_probes, point.max_flips, point.impl,
        point.screen_alpha, point.early_exit, point.exit_group,
        point.exit_slack,
    )
    if normalized:
        statics = tuple(
            pipeline.normalize_static_args(
                cfg, state.data.dtype, g["k"], point.mode, point.n_probes,
                point.max_flips, point.impl, point.screen_alpha,
                point.early_exit, point.exit_group, point.exit_slack,
            )
        )
    sig = _shape_signature((state, delta, tomb, queries, weights))
    return (sig, statics)


# -- the dispatch-mode tracker ------------------------------------------------


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class Tracker(TorchDispatchMode):
    """Charges the bytes of every storage an aten op returns (meta tensors
    included) until the storage dies, and checks the dtype contract of every
    op. Storages of the op's own arguments (in-place ops, views of the
    caller's tensors) are not charged again. ``peak`` is the high-water mark
    of the charged bytes; ``violations`` the AUD003 messages; ``ops`` the
    number of aten ops run; ``int8_ops`` the ops that took an int8 operand."""

    def __init__(self):
        super().__init__()
        self.live: dict[int, int] = {}
        self.current = 0
        self.peak = 0
        self.ops = 0
        self.violations: list[str] = []
        self.int8_ops: set[str] = set()

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def _check(self, name: str, inputs, outputs) -> None:
        for t in (*inputs, *outputs):
            if t.dtype == torch.float64:
                self.violations.append(
                    f"float64 tensor at op `{name}` — silent double promotion doubles "
                    f"every table and intermediate"
                )
                break
        if not any(t.dtype == torch.int8 for t in inputs):
            return
        self.int8_ops.add(name)
        if name not in budgets.INT8_ALLOWED_OPS:
            self.violations.append(
                f"int8 operand consumed by `{name}` — quantized rows may only move "
                f"(index/slice/view) and decode (_to_copy); arithmetic belongs after "
                f"the decode"
            )

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        inputs = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        outputs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self._account(func, inputs, outputs)
        return out

    def _account(self, func, inputs, outputs) -> None:
        """Count the op, check its dtypes, charge its new storages."""
        self.ops += 1
        self._check(func.overloadpacket.__name__, inputs, outputs)
        owned = {_storage_key(t) for t in inputs}
        for t in outputs:
            storage = t.untyped_storage()
            key = storage._cdata
            if key in owned or key in self.live:
                continue
            self.live[key] = storage.nbytes()
            self.current += self.live[key]
            self.peak = max(self.peak, self.current)
            weakref.finalize(storage, self._free, key)


def peak_live_bytes(fn) -> int:
    """Peak live bytes of the tensors ``fn``'s aten ops return (see
    :class:`Tracker`); tensors ``fn`` is given are not charged."""
    with Tracker() as tracker:
        fn()
    return tracker.peak


def dtype_violations(fn, path: str) -> list:
    """AUD003 findings of one run of ``fn``: float64 tensors at any op; int8
    operands of an op outside the movement/decode set."""
    with Tracker() as tracker:
        fn()
    return _failures(tracker.violations, path)


def _failures(messages, path: str) -> list:
    out = []
    for msg in dict.fromkeys(messages):  # the same breach once, in order
        measured, budget = (64, 32) if msg.startswith("float64") else (1, 0)
        out.append(AuditFailure("AUD003", path, msg, measured, budget))
    return out


def _launches_since(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``launch_counts()``), with
    their launches; the process's counts are left as they are."""
    now = _build.launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def measure(fn, device):
    """Run ``fn`` once under a :class:`Tracker`. Returns the tracker, ``fn``'s
    result (held until the tracker has closed) and, on the card, the CUDA
    allocator's peak above the pre-call baseline (None elsewhere)."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    with Tracker() as tracker:
        out = fn()
    allocator_peak = None
    if cuda:
        torch.cuda.synchronize(device)
        allocator_peak = torch.cuda.max_memory_allocated(device) - base
    return tracker, out, allocator_peak


@dataclasses.dataclass
class PointRun:
    peak: int  # tracker's peak live bytes
    ops: int
    violations: list
    int8_ops: set
    launches: dict  # kernel -> launches of this point
    allocator_peak: Optional[int]  # CUDA allocator's peak above the baseline (card only)


def query_point(point: AuditPoint, index, queries, weights):
    """The real ``pipeline.query`` at this lattice point, over ``index``'s
    leaves (its delta and tombstones on the segmented view only)."""
    from repro_torch.engine import pipeline

    state, delta, tomb = _view_args(index, point.view)
    return pipeline.query(
        state, delta, tomb, queries, weights,
        _audit_config(point.family, point.storage, point.window),
        k=budgets.AUDIT_GEOMETRY["k"], mode=point.mode, n_probes=point.n_probes,
        max_flips=point.max_flips, impl=point.impl,
        screen_alpha=point.screen_alpha, early_exit=point.early_exit,
        exit_group=point.exit_group, exit_slack=point.exit_slack,
    )


def run_point(point: AuditPoint, index, queries, weights, inject: Optional[str] = None
              ) -> PointRun:
    """Execute the real ``pipeline.query`` once at this lattice point under
    a :class:`Tracker`. ``inject="memory"`` charges the historical
    (b, L·P·C, cap) dense delta match, as a meta tensor, on segmented paths
    (the regression this audit exists to catch): 64 MiB at P = 1, 512 MiB
    at multiprobe p8."""
    g = budgets.AUDIT_GEOMETRY

    def call():
        answer = query_point(point, index, queries, weights)
        if inject == "memory" and point.view == "segmented":
            n_probes = point.n_probes if point.mode == "multiprobe" else 1  # as normalized
            slots = g["L"] * n_probes * (point.window or g["max_candidates"])
            torch.empty((queries.shape[0], slots, g["delta_capacity"]), dtype=torch.float32,
                        device="meta")  # charged while the answer is held, then dropped
        return answer

    before = _build.launch_counts()
    tracker, _, allocator_peak = measure(call, queries.device)
    return PointRun(tracker.peak, tracker.ops, tracker.violations, tracker.int8_ops,
                    _launches_since(before), allocator_peak)


# -- live normalization probe -------------------------------------------------


# The live probe's one warm call per genuinely distinct program:
# (mode, n_probes, impl, screen_alpha[, early_exit, exit_group, exit_slack]).
LIVE_PROBE_PROGRAMS = {
    "probe": ("probe", 1, "auto", 0.0),
    "multiprobe": ("multiprobe", 4, "auto", 0.0),
    "exact": ("exact", 1, "auto", 0.0),
    "stream": ("probe", 1, "auto", 0.0, True, 1, 0.1),  # L=2: 2 groups
}


def live_probe_inputs(device=None):
    """The live probe's tiny index (n=64, d=4, K=3, L=2, C=8) on ``device``
    and its two non-zero queries: ``(state, cfg, queries, weights)``."""
    from repro_torch.api.index import Index, resolve_device

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((64, 4), generator=gen)
    q = torch.rand((2, 4), generator=gen)
    w = 0.5 + torch.rand((2, 4), generator=gen)
    cfg = dataclasses.replace(_audit_config("theta", "f32"), d=4, K=3, L=2, max_candidates=8)
    return Index.build(0, data, cfg, device=dev).state, cfg, q.to(dev), w.to(dev)


def live_probe_call(state, cfg, queries, weights, mode, n_probes, impl, alpha, early=False,
                    group=0, slack=0.0):
    """One call of the live probe (k=3, max_flips=2) through the real entry."""
    from repro_torch.engine import pipeline

    return pipeline.query(
        state, None, None, queries, weights, cfg, k=3, mode=mode,
        n_probes=n_probes, max_flips=2, impl=impl, screen_alpha=alpha,
        early_exit=early, exit_group=group, exit_slack=slack,
    )


def live_normalization_probe(device=None) -> list:
    """Run the reference's denormalized static variants through the real
    entry point on a tiny index, each beside the normalized call it must
    equal: the same ``ids`` and ``dists`` bit for bit, the same launch
    counts, and no kernel library built or loaded (``RetraceGuard``) once
    the normalized calls have warmed up."""
    state, cfg, q, w = live_probe_inputs(device)

    def call(*args):
        before = _build.launch_counts()
        res = live_probe_call(state, cfg, q, w, *args)
        return res, _launches_since(before)

    warm = {name: call(*args) for name, args in LIVE_PROBE_PROGRAMS.items()}
    # redundant static variants — each must equal its normalized twin
    variants = (
        ("probe", ("probe", 8, "auto", 0.0)),  # probe ignores n_probes
        ("probe", ("probe", 1, "auto", 2.0)),  # f32 ignores screen_alpha
        ("multiprobe", ("multiprobe", 4, "gather", 0.0)),  # non-probe ignores impl
        ("exact", ("exact", 8, "gather", 2.0)),  # exact ignores all of them
        ("probe", ("probe", 1, "auto", 0.0, False, 7, 0.5)),  # knobs dead while off
        ("probe", ("probe", 1, "auto", 0.0, True, 2)),  # one group == off
        ("stream", ("probe", 8, "auto", 0.0, True, 1, 0.1)),  # n_probes folds
        ("exact", ("exact", 1, "auto", 0.0, True, 1, 0.1)),  # exact folds
    )
    failures = []
    guard = RetraceGuard()
    guard.snapshot()
    for twin, args in variants:
        res, launches = call(*args)
        want, want_launches = warm[twin]
        same = (torch.equal(res.ids, want.ids) and torch.equal(res.dists, want.dists)
                and launches == want_launches)
        if not same:
            failures.append(AuditFailure(
                "AUD002", "live-probe",
                f"the denormalized variant {args} answered or launched otherwise than its "
                f"normalized twin ({twin})", 1, 0,
            ))
    try:
        guard.assert_no_retrace(context="the live normalization probe")
    except AssertionError as e:
        failures.append(AuditFailure(
            "AUD002", "live-probe",
            f"denormalized static variants built or loaded a kernel library: {e}",
            guard.cache_size(), guard.baseline,
        ))
    return failures


# -- the audit ----------------------------------------------------------------


def run_audit(
    inject: Optional[str] = None,
    golden: Optional[dict] = None,
    live_probe: bool = True,
    device=None,
) -> dict:
    """Run the lattice, check every budget, and return the report dict
    (``report["ok"]`` is the gate verdict; ``report["failures"]`` name
    each breach with its code, path, and measured-vs-budget numbers).
    ``device`` defaults to the CUDA card, as every entry point of the port."""
    if inject not in (None, "memory", "retrace"):
        raise ValueError(
            f"inject must be None, 'memory', or 'retrace'; got {inject!r}"
        )
    from repro_torch.api.index import resolve_device

    dev = resolve_device(device)
    g = budgets.AUDIT_GEOMETRY
    indexes = build_audit_indexes(dev)
    queries = torch.zeros((g["b"], g["d"]), dtype=torch.float32, device=dev)
    weights = torch.ones((g["b"], g["d"]), dtype=torch.float32, device=dev)
    points = enumerate_points()

    # --- compile-key cardinality over the raw lattice
    normalized = inject != "retrace"
    keys: dict = {}
    for p in points:
        k = compile_key(p, indexes[(p.family, p.storage)], queries, weights,
                        normalized=normalized)
        keys.setdefault(k, []).append(p)
    failures: list = []
    n_keys = len(keys)
    if n_keys > budgets.RETRACE_BUDGET:
        # name an axis that failed to fold: two raw points sharing a
        # normalized key but split across raw keys
        example = ""
        if not normalized:
            by_norm: dict = {}
            for p in points:
                idx = indexes[(p.family, p.storage)]
                nk = compile_key(p, idx, queries, weights, normalized=True)
                by_norm.setdefault(nk, set()).add(
                    compile_key(p, idx, queries, weights, normalized=False)
                )
            split = next((v for v in by_norm.values() if len(v) > 1), None)
            if split:
                variants = sorted(str(s[1][2:]) for s in split)[:2]
                example = (
                    f"; e.g. one program now runs per static variant "
                    f"{' vs '.join(variants)}"
                )
        failures.append(
            AuditFailure(
                "AUD002", "lattice",
                f"compile-key cardinality {n_keys} exceeds the declared "
                f"retrace budget {budgets.RETRACE_BUDGET} — a static axis "
                f"is not folded by normalize_static_args{example}",
                n_keys, budgets.RETRACE_BUDGET,
            )
        )
    elif n_keys < budgets.RETRACE_BUDGET and golden is not None:
        failures.append(
            AuditFailure(
                "AUD004", "lattice",
                f"compile-key cardinality {n_keys} under budget "
                f"{budgets.RETRACE_BUDGET} — a lattice path disappeared; "
                f"update budgets.RETRACE_BUDGET and the golden if intended",
                n_keys, budgets.RETRACE_BUDGET,
            )
        )

    # --- every raw point runs once; a path is one compile key
    runs = {p: run_point(p, indexes[(p.family, p.storage)], queries, weights,
                         inject=inject if inject == "memory" else None)
            for p in points}
    paths = []
    worst = ("", 0)
    int8_ops = sorted(set().union(*(r.int8_ops for r in runs.values())))
    for pts in sorted(keys.values(), key=lambda pts: pts[0].name):
        rep = pts[0]
        peak = max(runs[p].peak for p in pts)
        dvs = _failures([m for p in pts for m in runs[p].violations], rep.name)
        failures += dvs
        row = {
            "name": rep.name,
            "peak_live_bytes": int(peak),
            "ops": runs[rep].ops,
            "dtype_ok": not dvs,
            "raw_variants": len(pts),
            "launches": runs[rep].launches,
        }
        if runs[rep].allocator_peak is not None:
            row["allocator_peak_bytes"] = max(runs[p].allocator_peak for p in pts)
        if rep.storage == "int8":
            row["int8_kernels"] = [k for k in STORED_KERNELS if k in runs[rep].launches]
        paths.append(row)
        if peak > worst[1]:
            worst = (rep.name, peak)
        if peak > budgets.MEMORY_ENVELOPE_BYTES:
            failures.append(
                AuditFailure(
                    "AUD001", rep.name,
                    f"peak live intermediates {peak / 2**20:.1f} MiB exceed "
                    f"the {budgets.MEMORY_ENVELOPE_BYTES / 2**20:.0f} MiB "
                    f"memory envelope — a (b, L·P·C, cap)-class "
                    f"materialization reached the path",
                    peak, budgets.MEMORY_ENVELOPE_BYTES,
                )
            )

    # --- golden diff (same backend only: the card's kernels allocate
    # otherwise than the plain versions)
    backend = dev.type
    if golden is not None and golden.get("backend") == backend:
        gpaths = golden.get("paths", {})
        for row in paths:
            want = gpaths.get(row["name"])
            if want is None:
                failures.append(
                    AuditFailure(
                        "AUD004", row["name"],
                        "path not in the golden budget — regenerate with "
                        "--write-golden if this lattice point is intended",
                        row["peak_live_bytes"], 0,
                    )
                )
                continue
            lo = want * (1 - budgets.GOLDEN_REL_TOL)
            hi = want * (1 + budgets.GOLDEN_REL_TOL)
            if not (lo <= row["peak_live_bytes"] <= hi):
                failures.append(
                    AuditFailure(
                        "AUD004", row["name"],
                        f"peak live bytes drifted beyond "
                        f"±{budgets.GOLDEN_REL_TOL:.0%} of the golden "
                        f"({want} bytes) — review, then --write-golden",
                        row["peak_live_bytes"], want,
                    )
                )
        for name in gpaths:
            if not any(r["name"] == name for r in paths):
                failures.append(
                    AuditFailure(
                        "AUD004", name,
                        "golden path no longer run — a lattice point "
                        "disappeared; regenerate the golden if intended",
                        0, gpaths[name],
                    )
                )
        gkeys = golden.get("compile_keys")
        if gkeys is not None and gkeys != n_keys and n_keys <= budgets.RETRACE_BUDGET:
            failures.append(
                AuditFailure(
                    "AUD004", "lattice",
                    f"compile-key count changed vs golden ({gkeys})",
                    n_keys, gkeys,
                )
            )

    if live_probe and inject is None:
        failures += live_normalization_probe(dev)

    return {
        "version": 1,
        "backend": backend,
        "geometry": dict(g),
        "inject": inject,
        "compile_keys": {
            "count": n_keys,
            "budget": budgets.RETRACE_BUDGET,
            "raw_points": len(points),
        },
        "memory": {
            "worst_path": worst[0],
            "max_peak_live_bytes": int(worst[1]),
            "envelope_bytes": budgets.MEMORY_ENVELOPE_BYTES,
        },
        "int8_ops": int8_ops,
        "paths": paths,
        "failures": [f.to_dict() for f in failures],
        "ok": not failures,
    }


def golden_from_report(report: dict) -> dict:
    return {
        "backend": report["backend"],
        "compile_keys": report["compile_keys"]["count"],
        "paths": {
            row["name"]: row["peak_live_bytes"] for row in report["paths"]
        },
    }


def load_golden(backend: str, path=None) -> Optional[dict]:
    """The checked-in golden of ``backend`` ("cpu" or "cuda"); None when
    there is none."""
    path = path or budgets.GOLDEN_PATHS[backend]
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return None
