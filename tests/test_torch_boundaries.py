"""Boundaries of the port: it imports neither ``jax`` nor ``repro`` (nor
``msgpack`` or ``ml_dtypes``, which the reference's persistence needs), its
entry points default to the CUDA card and refuse to carry on without one,
every part it does not port yet raises ``NotImplementedError``, and the
modes a slice ported (early exit, ``--stats``, persistence, quality-first
planning, the tuner, ``serve --recall-target``, sharding) run on the CPU (``serve
--mode broker`` is held in ``test_torch_serving.py``)."""

import inspect
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.api as tapi
from repro_torch.engine import pipeline

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"


def _port_modules():
    pkg = SRC / "repro_torch"
    for p in sorted(pkg.rglob("*.py")):
        rel = p.relative_to(SRC).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


FORBIDDEN = ("jax", "repro", "msgpack", "ml_dtypes")


def _forbidden(mod):
    """Any module whose top-level name starts with ``jax`` (``jaxlib``,
    ``jax_*``) or is one of ``FORBIDDEN``."""
    top = mod.split(".")[0]
    return top.startswith("jax") or top in FORBIDDEN


# The same predicate, run in a fresh interpreter after the imports under test.
_FORBIDDEN_CHECK = (
    f"FORBIDDEN = {FORBIDDEN!r}\n" + inspect.getsource(_forbidden)
    + "bad = sorted(m for m in sys.modules if _forbidden(m))\nassert not bad, bad\n"
)


def _run_clean(code):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_port_imports_no_jax_and_no_reference():
    mods = list(_port_modules())
    for m in ("repro_torch.kernels.ops", "repro_torch.launch.serve", "repro_torch.ckpt",
              "repro_torch.ckpt.checkpoint", "repro_torch.ckpt._msgpack",
              "repro_torch.api.persist", "repro_torch.api.planner", "repro_torch.tuner",
              "repro_torch.tuner.space", "repro_torch.tuner.scan", "repro_torch.tuner.pareto",
              "repro_torch.launch.tune"):
        assert m in mods, m
    _run_clean("import importlib, sys\n"
               f"for m in {mods!r}: importlib.import_module(m)\n" + _FORBIDDEN_CHECK)


def test_save_and_load_import_no_reference_msgpack_or_ml_dtypes(tmp_path):
    """A bf16 and an int8 index saved and loaded on the CPU: the payload
    packs and the bf16 leaf reads without ``msgpack`` or ``ml_dtypes``."""
    out = _run_clean(
        "import sys, numpy as np, torch\n"
        "import repro_torch.api as tapi\n"
        "data = np.random.default_rng(0).uniform(0, 1, (64, 4)).astype(np.float32)\n"
        "for storage in ('bf16', 'int8'):\n"
        "    cfg = tapi.IndexConfig(d=4, M=8, K=3, L=2, storage=storage,\n"
        "                           space=tapi.BoundedSpace(0.0, 1.0, 8.0))\n"
        "    idx = tapi.Index.build(0, data, cfg, update=tapi.UpdateSpec(delta_capacity=8),\n"
        "                           device='cpu')\n"
        "    idx, _ = idx.insert(data[:3])\n"
        f"    d = idx.save({str(tmp_path)!r} + '/' + storage)\n"
        "    back = tapi.Index.load(d, device='cpu')\n"
        "    assert torch.equal(back.state.data.view(torch.uint8), idx.state.data.view(torch.uint8))\n"
        "    assert back.delta_fill == 3 and back.state.data.dtype == idx.state.data.dtype\n"
        "    print(storage, back.state.data.dtype)\n" + _FORBIDDEN_CHECK
    )
    assert "bf16 torch.bfloat16" in out and "int8 torch.int8" in out


def test_chip_smoke_imports_no_jax_and_no_reference():
    text = (ROOT / "chip_smoke.py").read_text()
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            mod = s.split()[1]
            assert not _forbidden(mod), line


def _cfg(**kw):
    base = dict(d=4, M=8, K=3, L=2, space=tapi.BoundedSpace(0.0, 1.0, 8.0))
    base.update(kw)
    return tapi.IndexConfig(**base)


def test_build_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(0).uniform(0, 1, (16, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Index.build(0, data, _cfg())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Index.from_numpy({}, _cfg())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Index.load("no-such-directory")
    idx = tapi.Index.build(0, data, _cfg(), device="cpu")  # the explicit CPU path works
    assert idx.device.type == "cpu"


def test_query_runs_on_the_index_device():
    rs = np.random.default_rng(1)
    idx = tapi.Index.build(0, rs.uniform(0, 1, (16, 4)).astype(np.float32), _cfg(), device="cpu")
    res = idx.query(rs.uniform(0, 1, (3, 4)), np.ones((3, 4)), tapi.QuerySpec(k=2))
    assert res.dists.device.type == "cpu" and res.ids.dtype == torch.int32


@pytest.mark.parametrize(
    "make",
    [
        lambda: tapi.QuerySpec(k=5, impl="onehot"),
        lambda: tapi.QuerySpec(k=5, impl="gather"),
    ],
    ids=["impl", "impl_gather"],
)
def test_impl_specs_run_on_cpu_and_refuse_the_card(make):
    """``impl`` is ported: the plain projections it names run on CPU
    tensors, and anywhere else (the card) raise instead of running."""
    from repro_torch.core import hash_families as thf

    spec = make()
    rs = np.random.default_rng(3)
    idx = tapi.Index.build(0, rs.uniform(0, 1, (16, 4)).astype(np.float32), _cfg(), device="cpu")
    q, w = torch.rand((2, 4)), torch.ones((2, 4))
    assert torch.equal(idx.query(q, w, spec).ids, idx.query(q, w, tapi.QuerySpec(k=5)).ids)
    meta = thf.PrefixTables(folded=torch.zeros((6, 4, 9), device="meta"),
                            offsets=torch.zeros((6,), device="meta"))
    with pytest.raises(ValueError, match="runs on CPU tensors only"):
        thf.project_query(torch.zeros((2, 4), dtype=torch.int32, device="meta"),
                          torch.ones((2, 4), device="meta"), meta, impl=spec.impl)


@pytest.mark.parametrize("mutable", [False, True], ids=["sealed", "mutable"])
def test_early_exit_runs_on_cpu(mutable):
    """QuerySpec(early_exit=True) is accepted, and the streamed tail runs
    through Index.query and the engine entry on the CPU, stamping
    tables_probed and stop_reason."""
    rs = np.random.default_rng(2)
    data = rs.uniform(0, 1, (16, 4)).astype(np.float32)
    update = tapi.UpdateSpec(delta_capacity=8 if mutable else 0)
    idx = tapi.Index.build(0, data, _cfg(L=4), update=update, device="cpu")
    if mutable:
        idx, _ = idx.insert(rs.uniform(0, 1, (3, 4)))
    q = torch.as_tensor(rs.uniform(0, 1, (2, 4)), dtype=torch.float32)
    w = torch.ones((2, 4))
    spec = tapi.QuerySpec(k=2, early_exit=True, exit_group=2, exit_slack=0.1)
    res = idx.query(q, w, spec)
    assert res.tables_probed is not None and res.stop_reason is not None
    assert ((res.tables_probed >= 1) & (res.tables_probed <= 4)).all()
    assert set(res.stop_reason.tolist()) <= {0, 1, 2}
    eng = pipeline.query(idx.state, idx.delta if mutable else None,
                         idx.tombstones if mutable else None, q, w, idx.config, k=2,
                         early_exit=True, exit_group=2, exit_slack=0.1)
    assert torch.equal(eng.ids, res.ids) and torch.equal(eng.tables_probed, res.tables_probed)


def test_quality_spec_builds_on_cpu_and_shard_raises(one_torch_thread):
    """A QualitySpec (Queue A item 10) builds, queries and explains on the
    CPU; its plan travels into ``shard()``, where the sharded index answers
    it as the single-host index answers the same plan, and a QualitySpec
    that was never planned raises there (planning needs one host)."""
    from repro_torch.core.distributed import make_mesh

    rs = np.random.default_rng(2)
    data = rs.uniform(0, 1, (16, 4)).astype(np.float32)
    quality = tapi.QualitySpec(k=3, calibration_queries=8)
    built = tapi.Index.build(0, data, quality, device="cpu")
    idx = tapi.Index.build(0, data, _cfg(), device="cpu")
    q = rs.uniform(0, 1, (2, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # two tables: best effort
        res = idx.query(q, np.ones((2, 4)), quality)
    assert torch.equal(res.ids, idx.query(q, np.ones((2, 4)), idx.plan(quality)).ids)
    assert built.plans[quality].provenance == "calibrated"
    sharded = idx.shard(make_mesh((2,), ("data",), devices=["cpu"] * 2))
    assert sharded.plans == idx.plans and sharded.plans is not idx.plans
    sres = sharded.query(q, np.ones((2, 4)), quality)
    pres = sharded.query(q, np.ones((2, 4)), idx.plan(quality))
    assert torch.equal(sres.ids, pres.ids) and torch.equal(sres.dists, pres.dists)
    if idx.plan(quality).mode == "exact":
        assert torch.equal(sres.ids, res.ids)
    with pytest.raises(ValueError, match="cannot calibrate a new QualitySpec"):
        sharded.query(q, np.ones((2, 4)), tapi.QualitySpec(k=2, calibration_queries=8))
    rep = idx.explain(q, np.ones((2, 4)), quality)
    assert rep.quality == quality and rep.spec == idx.plan(quality)


def test_planner_and_tuner_need_the_card_by_default(monkeypatch):
    from repro_torch import tuner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = np.random.default_rng(0).uniform(0, 1, (16, 4)).astype(np.float32)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tapi.Index.build(0, data, tapi.QualitySpec(k=3))
    space = tuner.ScanSpace(profiles=(tuner.DataProfile(n=16, d=4),), families=("theta",),
                            K=(3,), L=(2,), n_probes=(1,), window=(8,), k=2, queries=4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tuner.run_trial(space.trials()[0].to_dict())


@pytest.fixture
def one_torch_thread():
    """A planning run is many small torch ops: one intra-op thread keeps it
    from oversubscribing the CPU when the suite runs in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_serve_recall_target_runs_on_cpu(capsys, one_torch_thread):
    from repro_torch.launch import serve

    serve.main(["--mode", "alsh", "--device", "cpu", "--n", "512", "--d", "8",
                "--query-batch", "16", "--batches", "1", "--recall-target", "0.8",
                "--latency-budget-ms", "5"])
    out = capsys.readouterr().out
    assert "(planned from QualitySpec)" in out and "serving policy: PlannedSpec(" in out
    assert "pred_success~" in out and "truncated=" in out


def test_tune_cli_runs_on_cpu(tmp_path, capsys, one_torch_thread):
    from repro_torch.launch import tune

    args = ["--device", "cpu", "--out", str(tmp_path), "--family", "theta", "--n", "256",
            "--d", "4", "--K", "4", "--L", "4", "--probes", "1", "2", "--window", "16",
            "--k", "3", "--queries", "8"]
    assert tune.main(args + ["--max-trials", "1"]) == 0
    assert "PARTIAL: 1/2" in capsys.readouterr().out
    assert tune.main(args) == 0
    out = capsys.readouterr().out
    assert "tuning table: 1 bucket(s)" in out and (tmp_path / "tuning_table.json").exists()


def test_shard_still_raises_naming_item_12(tmp_path):
    """Sharding is ported (Queue A item 12): a loaded index shards and
    answers as the built one does, in every mode, and both refuse a mesh
    that is not a ``Mesh`` alike."""
    from repro_torch.core.distributed import make_mesh

    rs = np.random.default_rng(5)
    data = rs.uniform(0, 1, (64, 4)).astype(np.float32)
    idx = tapi.Index.build(0, data, _cfg(L=4, max_candidates=16), device="cpu")
    loaded = tapi.Index.load(idx.save(tmp_path / "idx"), device="cpu")
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    q = rs.uniform(0, 1, (6, 4))
    w = np.abs(rs.normal(size=(6, 4))) + 0.2
    for spec in (tapi.QuerySpec(k=3), tapi.QuerySpec(k=3, mode="multiprobe", n_probes=4),
                 tapi.QuerySpec(k=3, mode="exact")):
        a = idx.shard(mesh).query(q, w, spec)
        b = loaded.shard(mesh).query(q, w, spec)
        assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)
        assert torch.equal(a.n_candidates, b.n_candidates)
    for index in (idx, loaded):
        with pytest.raises(TypeError, match="make_mesh"):
            index.shard(None)


@pytest.mark.parametrize("mode,arch", [("lm", "llama4-scout-17b-16e"), ("lm", "mamba2-2.7b")])
def test_serve_unported_modes_raise(mode, arch):
    """Every serve mode is ported; the LM mode raises for the architectures
    it does not run yet (MoE, SSM), naming their ROADMAP.md item."""
    from repro_torch.launch import serve

    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 14c"):
        serve.main(["--mode", mode, "--arch", arch, "--device", "cpu"])


def test_serve_alsh_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "alsh", "--device", "cpu", "--n", "512", "--d", "8", "--K", "4",
                "--L", "4", "--query-batch", "16", "--batches", "1"])
    out = capsys.readouterr().out
    assert "[alsh] built index over n=512 d=8" in out and "[alsh] batch 0:" in out


def test_serve_alsh_quantized_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "alsh", "--device", "cpu", "--n", "512", "--d", "8", "--K", "4",
                "--L", "4", "--query-batch", "16", "--batches", "1", "--storage", "int8",
                "--screen-alpha", "2", "--multiprobe", "--probes", "4"])
    out = capsys.readouterr().out
    assert "storage=int8" in out and "[alsh] batch 0:" in out
    assert "mode='multiprobe', n_probes=4" in out and "screen_alpha=2.0" in out


def test_serve_early_exit_stats_runs_on_cpu(capsys):
    """--early-exit --stats serves through the streamed tail and prints the
    storage line and the tables_probed / stop-reason line."""
    from repro_torch.launch import serve

    serve.main(["--mode", "alsh", "--device", "cpu", "--n", "512", "--d", "8", "--K", "4",
                "--L", "8", "--query-batch", "16", "--batches", "1", "--early-exit",
                "--exit-group", "2", "--stats"])
    out = capsys.readouterr().out
    assert "early_exit=True, exit_group=2, exit_slack=0.1" in out
    assert "[alsh]   stats: storage=f32" in out
    assert "[alsh]   stats: tables_probed~" in out and "/8 stop_reasons={" in out


def test_serve_stats_without_early_exit_runs_on_cpu(capsys):
    """--stats on a screened int8 table prints the storage line only: the
    screen folds early exit off, so no query streamed."""
    from repro_torch.launch import serve

    serve.main(["--mode", "alsh", "--device", "cpu", "--n", "512", "--d", "8", "--K", "4",
                "--L", "4", "--query-batch", "16", "--batches", "1", "--storage", "int8",
                "--early-exit", "--stats"])
    out = capsys.readouterr().out
    assert "[alsh]   stats: storage=int8" in out and "early_exit=False" in out
    assert "tables_probed" not in out


def test_serve_quantized_without_a_card_raises(monkeypatch):
    """Without --device cpu the service asks for the card, quantized or not."""
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--mode", "alsh", "--n", "512", "--d", "8", "--storage", "int8"])


def test_query_validation_matches_reference_messages():
    rs = np.random.default_rng(3)
    idx = tapi.Index.build(0, rs.uniform(0, 1, (16, 4)).astype(np.float32), _cfg(), device="cpu")
    with pytest.raises(ValueError, match="trailing dim config.d=4"):
        idx.query(np.zeros((2, 3)), np.ones((2, 3)))
    bad = np.zeros((3, 4))
    bad[1, 2] = np.nan
    with pytest.raises(ValueError, match=r"non-finite values \(NaN/Inf\) in 1 of 3 rows \[1\]"):
        idx.query(bad, np.ones((3, 4)))


def test_kernel_dispatch_never_quietly_falls_back():
    """A CPU tensor takes the plain version; an unknown force is refused;
    the CUDA wrappers refuse CPU tensors instead of computing on them."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.alsh_project import alsh_project_cuda
    from repro_torch.kernels.gather_rerank import (
        gather_rerank_topk_blocked_cuda,
        gather_rerank_topk_cuda,
    )
    from repro_torch.kernels.wl1_distance import wl1_rerank_cuda, wl1_scan_cuda
    from repro_torch.kernels.wl1_topk import wl1_scan_topk_cuda

    lv = torch.zeros((2, 3), dtype=torch.int32)
    folded = torch.ones((4, 3, 5))
    assert torch.equal(ops.alsh_project(lv, folded), torch.full((2, 4), 3.0))
    with pytest.raises(ValueError, match="force"):
        ops.alsh_project(lv, folded, force="ref")
    x = torch.zeros((5, 3))
    with pytest.raises(ValueError, match="CUDA"):
        alsh_project_cuda(lv, folded)
    with pytest.raises(ValueError, match="CUDA"):
        wl1_scan_topk_cuda(x, x[:2], x[:2], 1)
    with pytest.raises(ValueError, match="CUDA"):
        wl1_scan_cuda(x, x[:2], x[:2])
    with pytest.raises(ValueError, match="CUDA"):
        wl1_rerank_cuda(x[None], x[:1], x[:1])
    with pytest.raises(ValueError, match="CUDA"):
        gather_rerank_topk_cuda(x, lv, x[:2], x[:2], 1)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rerank_topk_blocked_cuda(x.to(torch.int8), lv, x[:2], x[:2], 1)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rerank_topk_cuda(x, lv, x[:2], x[:2], 1, delta=x)
    with pytest.raises(ValueError, match="CUDA"):
        gather_rerank_topk_blocked_cuda(x.to(torch.int8), lv, x[:2], x[:2], 1,
                                        delta=x.to(torch.int8))
    # the two-segment gather on CPU tensors: the plain version over [data; delta]
    d2 = torch.arange(15.0).reshape(5, 3)
    ids = torch.tensor([[9, 2, 7], [10, 11, -1]], dtype=torch.int32)
    got = ops.gather_rerank_topk(x, ids, x[:2], torch.ones((2, 3)), 2, delta=d2)
    assert got[1].tolist() == [[2, 7], [-1, -1]]
