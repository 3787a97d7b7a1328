"""The port's static-contract gate (``repro_torch.analysis``) against the
reference's (``repro.analysis``), case for case with ``tests/test_analysis.py``
(CPU).

Lint: every RPR rule fires on a minimal bad snippet in torch idiom and
stays silent on its clean counterpart; allow markers suppress only with a
reason (RPR000 otherwise); the catalog's codes are the reference's; on the
language-neutral snippets both linters agree line for line; the port's tree
lints clean.

Audit: the lattice is the reference's, point for point; the port's
``normalize_static_args`` equals the reference's on every raw point; the
HEAD audit passes on the CPU and round-trips the CPU golden; the two seeded
regressions fail with AUD001/AUD002, measured and budget values included;
golden drift is AUD004; the live probe passes. The four audit indexes are
built once in a module fixture.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from repro.analysis import audit as jaudit
from repro.analysis import lint as jlint
from repro.engine.pipeline import normalize_static_args as j_normalize
from repro_torch.analysis import (
    RetraceError,
    RetraceGuard,
    cache_size,
    engine_cache_size,
    lint_paths,
    lint_source,
)
from repro_torch.analysis import audit, budgets
from repro_torch.analysis.lint import RULES
from repro_torch.engine.pipeline import normalize_static_args
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref

ENGINE = "repro_torch/engine/mod.py"  # branch + hot scope
CORE = "repro_torch/core/mod.py"  # branch scope only
KERNELS = "repro_torch/kernels/mod.py"
OUTSIDE = "repro_torch/serving/mod.py"  # neither
SRC = Path(audit.__file__).resolve().parents[2]  # .../src


def codes(src, relpath=ENGINE):
    return [f.code for f in lint_source(src, relpath)]


# ---------------------------------------------------------------------------
# lint: one bad + one clean snippet per rule
# ---------------------------------------------------------------------------


def test_rpr001_tensor_branch_fires_and_clean():
    bad = "def f(x):\n    if torch.sum(x) > 0:\n        return x\n    return -x\n"
    assert codes(bad) == ["RPR001"]
    assert codes(bad, CORE) == ["RPR001"]
    # a tensor method result is a tensor too
    assert codes("def f(x):\n    if (x > 0).any():\n        return x\n") == ["RPR001"]
    # static branches: clean (metadata, shapes, flags)
    assert codes("def f(x, flag):\n    if flag and x.shape[0]:\n        return x\n") == []
    assert codes("def f(x):\n    if x.dtype == torch.float32 and torch.cuda.is_available():\n"
                 "        return x\n") == []
    # numpy on the host is not a tensor
    assert codes("def f(x):\n    if np.any(x):\n        return x\n") == []
    # the same branch outside the branch scopes: clean
    assert codes(bad, OUTSIDE) == []


def test_rpr001_while_ternary_assert():
    assert codes("def f(x):\n    while x.any():\n        x = x - 1\n") == ["RPR001"]
    assert codes("def f(x):\n    y = 1 if torch.all(x) else 2\n    return y\n") == ["RPR001"]
    assert codes("def f(x):\n    assert torch.isfinite(x).all()\n", CORE) == ["RPR001"]


def test_rpr002_host_sync_fires_and_clean():
    assert codes("def f(x):\n    return x.item()\n") == ["RPR002"]
    assert codes("def f(x):\n    return x.tolist()\n") == ["RPR002"]
    assert codes("def f(x):\n    return x.cpu().numpy()\n") == ["RPR002", "RPR002"]
    assert codes("def f(x):\n    torch.cuda.synchronize()\n    return x\n") == ["RPR002"]
    assert codes("def f(x):\n    return float(g(x))\n") == ["RPR002"]
    assert codes("def f(x):\n    return int(x[0])\n", KERNELS) == ["RPR002"]
    # off the hot path (serving, core may sync): clean
    assert codes("def f(x):\n    return x.item()\n", OUTSIDE) == []
    assert codes("def f(x):\n    return x.cpu()\n", CORE) == []
    # a plain name is usually a python scalar; int(text, 16) parses text
    assert codes("def f(x):\n    return float(x)\n") == []
    assert codes("def f(m):\n    return int(m.group(1), 16)\n") == []


def test_rpr003_distance_fill_fires_and_clean():
    assert codes("def f():\n    return torch.full((2,), 1e9)\n") == ["RPR003"]
    assert codes("def f(x):\n    return x.masked_fill(x < 0, 1e10)\n") == ["RPR003"]
    assert codes("def f(x):\n    return x + 1e38\n") == ["RPR003"]
    assert codes("def f():\n    return torch.full((2,), float('inf'))\n") == []
    assert codes("def f(x):\n    return torch.full_like(x, torch.inf)\n") == []


def test_rpr004_id_sentinel_fires_and_clean():
    assert codes("def f():\n    return torch.full((2,), -2)\n") == ["RPR004"]
    assert codes("def f(x):\n    return x.new_full((2,), -9)\n") == ["RPR004"]
    assert codes("def f(ids):\n    return ids == -7\n") == ["RPR004"]
    assert codes("def f(ids):\n    return torch.full((2,), -1), ids == -1\n") == []
    # a negative axis is neither a fill nor a comparison
    assert codes("def f(x):\n    return x.sum(dim=-2)\n") == []


def test_rpr005_unhashable_memo_default():
    bad = "@functools.cache\ndef f(x, opts=[]):\n    return x\n"
    assert codes(bad) == ["RPR005"]
    bad_kw = "@functools.lru_cache(maxsize=8)\ndef f(x, *, opts={}):\n    return x\n"
    assert codes(bad_kw) == ["RPR005"]
    assert codes("@functools.cache\ndef f(x, opts=()):\n    return x\n") == []
    # an unmemoized function may take a mutable default (another lint's business)
    assert codes("def f(x, opts=[]):\n    return x\n") == []


def test_rpr006_import_time_torch_fires_and_clean():
    assert codes("X = torch.arange(4)\n") == ["RPR006"]
    assert codes("FREE = torch.cuda.mem_get_info()\n") == ["RPR006"]
    assert codes("class C:\n    Z = torch.zeros(3)\n") == ["RPR006"]
    assert codes("def f(x=torch.ones(2)):\n    return x\n") == ["RPR006"]
    assert codes("def f():\n    return torch.arange(4)\n") == []
    # static metadata at module scope is fine
    assert codes("DT = torch.iinfo(torch.int32)\nDEV = torch.device('cpu')\n") == []


def test_rpr007_kernels_confined_to_kernels():
    for snippet in (
        "import ctypes\n",
        "from torch.utils.cpp_extension import load\n",
        "from torch.utils import cpp_extension\n",
        "import triton\n",
        "def f(src):\n    return subprocess.run(['nvcc', src])\n",
        "def f(K):\n    return K.lib().alsh_project_launch()\n",
        "def f():\n    return Kernel('x', 'x.cu', {})\n",
    ):
        assert codes(snippet, OUTSIDE) == ["RPR007"], snippet
        assert codes(snippet, KERNELS) == [], snippet
    assert codes("def f(x):\n    return subprocess.run(['ls', x])\n", OUTSIDE) == []


def test_rpr008_private_build_poke():
    poke = "def f():\n    return _build._LIBRARY_LOADS\n"
    imp = "from repro_torch.kernels._build import _LIBRARY_LOADS\n"
    assert codes(poke, OUTSIDE) == ["RPR008"]
    assert codes(imp, OUTSIDE) == ["RPR008"]
    assert codes(poke, "repro_torch/analysis/x.py") == []
    assert codes(imp, KERNELS) == []
    assert codes("def f():\n    return _build.library_loads(), _build.launch_counts()\n",
                 OUTSIDE) == []


def test_allowlist_needs_reason_and_suppresses():
    bad = "def f(x):\n    if x.any():  # repro: allow[RPR001]\n        return x\n"
    assert codes(bad) == ["RPR000", "RPR001"]  # reasonless marker suppresses nothing
    ok = "def f(x):\n    if x.any():  # repro: allow[RPR001] host-only helper\n        return x\n"
    assert codes(ok) == []
    above = (
        "def f(x):\n"
        "    # repro: allow[RPR001] host-only helper\n"
        "    if x.any():\n"
        "        return x\n"
    )
    assert codes(above) == []
    # one marker per code: a line with two findings takes two markers
    both = "def f(live):\n    if bool(live.any()):  # repro: allow[RPR002] host loop\n        pass\n"
    assert codes(both) == ["RPR001"]
    both_ok = ("def f(live):\n    # repro: allow[RPR001] host loop\n"
               "    if bool(live.any()):  # repro: allow[RPR002] host loop\n        pass\n")
    assert codes(both_ok) == []
    # wrong code does not suppress
    wrong = "def f(x):\n    if x.any():  # repro: allow[RPR002] wrong code\n        return x\n"
    assert codes(wrong) == ["RPR001"]


def test_rule_catalog_is_the_reference_s():
    assert set(RULES) == set(jlint.RULES) == {f"RPR00{i}" for i in range(9)}


@pytest.mark.parametrize("src", [
    "def f(x):\n    return x  # repro: allow[RPR001]\n",  # RPR000
    "def f(x):\n    y = x + 1e38\n    return y - 3e31\n",  # RPR003, bare literals
    "def f(ids):\n    a = ids == -7\n    return a, ids != -1, ids < -3\n",  # RPR004
])
def test_language_neutral_snippets_agree_with_the_reference(src):
    mine = [(f.code, f.line) for f in lint_source(src, ENGINE)]
    theirs = [(f.code, f.line) for f in jlint.lint_source(src, "repro/engine/mod.py")]
    assert mine == theirs and mine


def test_repo_tree_is_clean():
    """The gate's contract on HEAD: zero unexplained findings in src/repro_torch."""
    assert lint_paths([SRC / "repro_torch"], root=SRC) == []


# ---------------------------------------------------------------------------
# retrace guard
# ---------------------------------------------------------------------------


def test_retrace_guard_watches_a_count():
    count = [1]
    guard = RetraceGuard(fn=lambda: count[0])
    with pytest.raises(RuntimeError):
        guard.assert_no_retrace()  # snapshot first
    guard.snapshot()
    assert guard.snapshotted and guard.baseline == 1
    guard.assert_no_retrace()
    count[0] = 2  # a library built after the snapshot
    with pytest.raises(RetraceError, match="grew 1 -> 2"):
        guard.assert_no_retrace(context="shape change")
    assert issubclass(RetraceError, AssertionError)


def test_retrace_guard_context_manager():
    count = [0]
    with RetraceGuard(fn=lambda: count[0]):
        pass
    with pytest.raises(RetraceError):
        with RetraceGuard(fn=lambda: count[0]):
            count[0] += 1
    assert cache_size(lambda: count[0]) == 1
    assert cache_size() == engine_cache_size() == _build.library_loads() >= 0


# ---------------------------------------------------------------------------
# audit: the tracker and the dtype contract (unit level, no index builds)
# ---------------------------------------------------------------------------


def test_peak_live_bytes_sees_large_intermediate():
    x = torch.zeros(())

    def f():
        y = torch.zeros((512, 512)) + x
        return y.sum()

    assert audit.peak_live_bytes(f) >= 2 * 512 * 512 * 4  # zeros and the sum's operand


def test_tracker_frees_dead_storages_and_counts_meta_tensors():
    with audit.Tracker() as t:
        a = torch.zeros((256, 256))
        view = a.view(-1)  # a view is the same storage: not charged again
        assert t.current == 256 * 256 * 4
        del a
        assert t.current == 256 * 256 * 4  # the view keeps it alive
        del view
        assert t.current == 0
        meta = torch.empty((8, 512, 4096), device="meta")  # no memory, charged all the same
        assert t.current == 8 * 512 * 4096 * 4
        del meta
        b = torch.ones(4)
        b.add_(1)  # in place: the storage is the argument's
    assert t.peak == 8 * 512 * 4096 * 4 and t.current == 4 * 4


def test_measure_holds_the_result_and_has_no_allocator_peak_off_the_card():
    tracker, out, allocator_peak = audit.measure(lambda: torch.zeros((64, 64)) + 1, "cpu")
    assert out.shape == (64, 64) and tracker.peak == 2 * 64 * 64 * 4
    assert tracker.current == 64 * 64 * 4  # the held result, the zeros freed
    assert allocator_peak is None


def test_live_probe_programs_answer_on_non_zero_queries():
    """The live probe's four programs on its non-zero queries: full top-k
    over n=64 live rows, exact equal to a brute-force scan."""
    state, cfg, q, w = audit.live_probe_inputs("cpu")
    assert bool((q != 0).all()) and q.shape == (2, 4)
    for name, args in audit.LIVE_PROBE_PROGRAMS.items():
        res = audit.live_probe_call(state, cfg, q, w, *args)
        assert res.ids.shape == (2, 3) and bool(torch.isfinite(res.dists).all()), name
    exact = audit.live_probe_call(state, cfg, q, w, *audit.LIVE_PROBE_PROGRAMS["exact"])
    brute = (w[:, None, :] * (state.data[None] - q[:, None, :]).abs()).sum(-1)
    assert torch.allclose(exact.dists, brute.topk(3, largest=False).values, rtol=1e-6)


def test_dtype_violations_flag_f64_and_int8_arithmetic():
    x8 = torch.zeros(4, dtype=torch.int8)
    found = audit.dtype_violations(lambda: x8 * 2, "unit")  # int8 mul — quantized arithmetic
    assert [f.code for f in found] == ["AUD003"] and "int8" in found[0].message
    f64 = torch.zeros(4)
    found = audit.dtype_violations(lambda: f64.double() + 1, "unit")
    assert found and all(f.code == "AUD003" for f in found)
    assert any("float64" in f.message for f in found)

    rows = torch.zeros((8, 4), dtype=torch.int8)
    idx = torch.zeros(3, dtype=torch.int64)
    # move, then decode, then compute
    ok = audit.dtype_violations(lambda: torch.index_select(rows, 0, idx).float() * 2.0, "unit")
    assert ok == []


# ---------------------------------------------------------------------------
# audit: the lattice against the reference (no builds)
# ---------------------------------------------------------------------------


def test_points_are_the_reference_s_in_order():
    mine, theirs = audit.enumerate_points(), jaudit.enumerate_points()
    assert [p.name for p in mine] == [p.name for p in theirs]
    assert [dataclasses.astuple(p) for p in mine] == [dataclasses.astuple(p) for p in theirs]
    assert len(mine) == 146


_DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16),
           "int8": (torch.int8, jnp.int8)}


@pytest.mark.parametrize("family,storage", audit.AUDIT_BUILDS)
def test_normalize_static_args_equals_the_reference_s(family, storage):
    tdt, jdt = _DTYPES[storage]
    g = budgets.AUDIT_GEOMETRY
    points = [p for p in audit.enumerate_points() if (p.family, p.storage) == (family, storage)]
    assert points
    for p in points:
        statics = (g["k"], p.mode, p.n_probes, p.max_flips, p.impl, p.screen_alpha,
                   p.early_exit, p.exit_group, p.exit_slack)
        mine = normalize_static_args(audit._audit_config(family, storage, p.window), tdt,
                                     *statics)
        theirs = j_normalize(jaudit._audit_config(family, storage, p.window), jdt, *statics)
        assert (mine[0] is None) == (theirs[0] is None), p.name
        if mine[0] is not None:
            assert dataclasses.asdict(mine[0]) == dataclasses.asdict(theirs[0]), p.name
        assert mine[1:] == theirs[1:], p.name


def test_normalize_static_args_folds_redundant_axes():
    cfg = audit._audit_config("theta", "f32")
    f32, i8 = torch.float32, torch.int8
    # probe ignores n_probes/max_flips/alpha(f32)
    a = normalize_static_args(cfg, f32, 3, "probe", 8, 3, "auto", 2.0)
    b = normalize_static_args(cfg, f32, 3, "probe", 1, 0, "auto", 0.0)
    assert a == b
    # exact drops cfg, impl, alpha entirely (and the early-exit knobs)
    a = normalize_static_args(cfg, i8, 3, "exact", 8, 3, "gather", 2.0)
    assert a == (None, 3, "exact", 1, 0, "auto", 0.0, False, 0, 0.0)
    # int8 keeps a real alpha; multiprobe folds impl but keeps probes
    a = normalize_static_args(cfg, i8, 3, "multiprobe", 4, 2, "gather", 2.0)
    assert a == (cfg, 3, "multiprobe", 4, 2, "auto", 2.0, False, 0, 0.0)
    # early exit: dead knobs zero while off; an active screen folds it off;
    # a single group folds it off; a live streamed point keeps its knobs
    a = normalize_static_args(cfg, f32, 3, "probe", 1, 0, "auto", 0.0, False, 16, 0.5)
    assert a == b
    a = normalize_static_args(cfg, i8, 3, "probe", 1, 0, "auto", 2.0, True, 4, 0.1)
    assert a[7:] == (False, 0, 0.0)
    a = normalize_static_args(cfg, f32, 3, "probe", 1, 0, "auto", 0.0, True, cfg.L, 0.1)
    assert a == b
    a = normalize_static_args(cfg, f32, 3, "probe", 1, 0, "auto", 0.0, True, 4, 0.1)
    assert a[7:] == (True, 4, 0.1)


# ---------------------------------------------------------------------------
# audit: the full lattice (one shared build of the four indexes)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def audit_indexes():
    return audit.build_audit_indexes("cpu")


@pytest.fixture()
def cached_build(monkeypatch, audit_indexes):
    monkeypatch.setattr(audit, "build_audit_indexes", lambda device: audit_indexes)


def test_lattice_folds_to_64_keys(audit_indexes):
    g = budgets.AUDIT_GEOMETRY
    q = torch.zeros((g["b"], g["d"]))
    w = torch.ones_like(q)
    points = audit.enumerate_points()
    keys = {audit.compile_key(p, audit_indexes[(p.family, p.storage)], q, w) for p in points}
    raw = {audit.compile_key(p, audit_indexes[(p.family, p.storage)], q, w, normalized=False)
           for p in points}
    assert len(keys) == budgets.RETRACE_BUDGET == 64
    assert len(raw) == len(points) == 146


def test_audit_head_passes_and_golden_round_trips(cached_build):
    golden = audit.load_golden("cpu")
    assert golden is not None, "golden_budget_cpu.json must be checked in"
    report = audit.run_audit(golden=golden, live_probe=True, device="cpu")
    assert report["failures"] == []
    assert report["ok"] and report["backend"] == "cpu"
    assert report["compile_keys"]["count"] == budgets.RETRACE_BUDGET
    assert report["compile_keys"]["raw_points"] > report["compile_keys"]["count"]
    # the worst legitimate path keeps half the envelope as headroom
    assert report["memory"]["max_peak_live_bytes"] <= budgets.MEMORY_ENVELOPE_BYTES // 2
    # int8 only moves and decodes
    assert set(report["int8_ops"]) <= budgets.INT8_ALLOWED_OPS
    # the CPU runs the plain versions: no kernel launches, none for int8
    assert all(row["launches"] == {} for row in report["paths"])
    assert all(row["int8_kernels"] == [] for row in report["paths"] if "/int8/" in row["name"])
    # round trip: a golden regenerated from this report is the one on disk
    assert audit.golden_from_report(report) == golden


def test_seeded_memory_regression_fails_with_named_diagnostic(cached_build, monkeypatch):
    sub = [
        p for p in audit.enumerate_points()
        if p.view == "segmented" and p.family == "theta" and p.storage == "f32"
        and p.mode == "probe"
    ]
    assert sub
    monkeypatch.setattr(audit, "enumerate_points", lambda: sub)
    report = audit.run_audit(inject="memory", live_probe=False, device="cpu")
    assert not report["ok"]
    breaches = [f for f in report["failures"] if f["code"] == "AUD001"]
    assert breaches, report["failures"]
    for f in breaches:
        assert f["path"].startswith("theta/f32/segmented/probe")
        assert f["measured"] > f["budget"] == budgets.MEMORY_ENVELOPE_BYTES
        assert "memory envelope" in f["message"]
    # the dense (b, L·C, cap) f32 tensor is 64 MiB at the full probe window
    assert max(f["measured"] for f in breaches) > 2 * budgets.MEMORY_ENVELOPE_BYTES


def test_seeded_retrace_regression_fails_with_named_diagnostic(
    cached_build, monkeypatch, audit_indexes
):
    sub = [
        p for p in audit.enumerate_points()
        if p.family == "theta" and p.storage == "f32" and p.view == "sealed"
    ]
    g = budgets.AUDIT_GEOMETRY
    q = torch.zeros((g["b"], g["d"]))
    w = torch.ones_like(q)
    folded = len(
        {audit.compile_key(p, audit_indexes[(p.family, p.storage)], q, w) for p in sub}
    )
    assert folded < len(sub)  # the sublattice carries redundant axes
    monkeypatch.setattr(audit, "enumerate_points", lambda: sub)
    monkeypatch.setattr(budgets, "RETRACE_BUDGET", folded)
    report = audit.run_audit(inject="retrace", live_probe=False, device="cpu")
    assert not report["ok"]
    (breach,) = [f for f in report["failures"] if f["code"] == "AUD002"]
    assert breach["measured"] == len(sub) > breach["budget"] == folded
    assert "normalize_static_args" in breach["message"]
    assert "static variant" in breach["message"]  # names an unfolded axis


def test_audit_rejects_unknown_injection():
    with pytest.raises(ValueError, match="inject"):
        audit.run_audit(inject="bogus", device="cpu")


def test_golden_drift_is_reported(cached_build):
    golden = audit.load_golden("cpu")
    skewed = {
        "backend": golden["backend"],
        "compile_keys": golden["compile_keys"],
        "paths": {k: v * 2 for k, v in golden["paths"].items()},
    }
    report = audit.run_audit(golden=skewed, live_probe=False, device="cpu")
    drift = [f for f in report["failures"] if f["code"] == "AUD004"]
    assert len(drift) == len(golden["paths"]) and all("golden" in f["message"] for f in drift)


def test_live_normalization_probe_passes():
    assert audit.live_normalization_probe("cpu") == []


def test_segmented_plain_gather_keeps_three_row_blocks(audit_indexes):
    """The repaired plain two-segment gather (the CPU path's largest
    intermediate): at the audit geometry its peak stays under half the
    envelope, and it answers bit for bit as the single-table tail over
    ``cat([main, delta])``."""
    gen = torch.Generator().manual_seed(5)
    main = torch.rand((4096, 16), generator=gen)
    delta = torch.rand((4096, 16), generator=gen)
    ids = torch.randint(0, 8192 + 64, (8, 8192), generator=gen, dtype=torch.int32)
    q = torch.rand((8, 16), generator=gen)
    w = torch.rand((8, 16), generator=gen) + 0.5
    block = 8 * 8192 * 16 * 4
    out = {}
    peak = audit.peak_live_bytes(
        lambda: out.setdefault("got", tref.gather_rerank_topk_segmented(main, delta, ids, q, w, 10)))
    assert peak <= 3 * block + 2**20 < budgets.MEMORY_ENVELOPE_BYTES // 2
    want = tref.gather_rerank_topk(torch.cat([main, delta]), ids, q, w, 10)
    assert torch.equal(out["got"][0], want[0]) and torch.equal(out["got"][1], want[1])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", *args],
                          capture_output=True, text=True, env=env, cwd=cwd, timeout=600)


def test_cli_lint_only_exits_0(tmp_path):
    out = _cli("--device", "cpu", "--lint-only", cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 finding(s)" in out.stdout


def test_cli_seeded_memory_regression_exits_1(tmp_path):
    out = _cli("--device", "cpu", "--seed-regression", "memory", "--report",
               str(tmp_path / "r.json"), cwd=tmp_path)
    assert out.returncode == 1, out.stdout + out.stderr
    assert "AUD001 theta/f32/segmented/probe/w64" in out.stdout
    assert "146 raw lattice points -> 64 compile keys" in out.stdout


def test_cli_runs_on_the_card_by_default(monkeypatch, tmp_path):
    """Without a card and without ``--device cpu`` the audit raises; it
    never falls back to the CPU."""
    from repro_torch.analysis.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        main(["--audit-only", "--report", str(tmp_path / "r.json")])
