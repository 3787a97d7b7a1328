"""The port's dry-run tooling against the JAX package's (CPU): ``launch/specs``
(concrete batches byte for byte, abstract ones by shape and dtype),
``launch/mesh``, ``launch/compile.lower_cell`` and ``launch/dryrun``
(``run_cell``, ``main``, the HLO collective parser and the lever set).

Every step run here is a meta run of a reduced config at a small shape
(``reduced_model``; the full-width spec arithmetic is in
``tests/test_torch_sharding.py``). A meta run's outputs must have the
shapes and dtypes of the same step run on real CPU tensors, and the
memoizing ``MetaTracker`` must count the ops and the peak the plain
``Tracker`` counts.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.configs as jconfigs
import repro.launch.dryrun as jdryrun
from repro.launch import specs as jspecs
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.analysis.audit import Tracker
from repro_torch.launch import compile as tcompile
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import sharding as tsh
from repro_torch.runtime import train_step as tts
from test_dryrun_parse import FAKE_HLO

FRONTENDS = ["gemma3-1b", "hubert-xlarge", "qwen2-vl-2b"]
FAMILIES = ["gemma3-1b", "hubert-xlarge", "qwen2-vl-2b", "llama4-scout-17b-16e", "mamba2-2.7b",
            "zamba2-7b"]
# small cells with the production cells' names and kinds: (seq, batch, kind)
SMALL = {"train_4k": (32, 16, "train"), "prefill_32k": (32, 16, "prefill"),
         "decode_32k": (32, 16, "decode"), "long_500k": (64, 1, "decode")}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    tsh.set_policy()


def _reduced_bundle(arch, **model_overrides):
    b = tconfigs.get_bundle(arch)
    cfg = dataclasses.replace(tconfigs.reduced_model(b.model), **model_overrides)
    return dataclasses.replace(b, model=cfg)


def _scout16(**model_overrides):
    """Reduced llama4-scout with 16 experts: they split over a 16-wide EP axis."""
    b = _reduced_bundle("llama4-scout-17b-16e", **model_overrides)
    return dataclasses.replace(b, model=dataclasses.replace(
        b.model, moe=dataclasses.replace(b.model.moe, n_experts=16)))


def _shape(name):
    seq, batch, kind = SMALL[name]
    return tconfigs.ShapeConfig(name, seq, batch, kind)


def _leaves(tree):
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [x for v in tree for x in _leaves(v)]


# ---------------------------------------------------------------------------
# launch/specs and launch/mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FRONTENDS)
def test_batches_match_the_reference(arch):
    """Concrete batches equal the reference's byte for byte; abstract ones
    are meta tensors of its shapes and dtypes (the vision clamp kept)."""
    jcfg = jconfigs.reduced_model(jconfigs.get_bundle(arch).model)
    tcfg = tconfigs.reduced_model(tconfigs.get_bundle(arch).model)
    for name, args in (("train_batch", (3, 20)), ("prefill_batch", (3, 20)),
                       ("decode_batch", (3, 17)), ("train_batch", (2, 6))):
        want = getattr(jspecs, name)(jcfg, *args, concrete=True)
        got = getattr(tspecs, name)(tcfg, *args, concrete=True, device="cpu")
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            w = np.asarray(w)
            g = got[k].numpy()
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            assert g.tobytes() == w.tobytes(), (name, k)
        abstract = getattr(tspecs, name)(tcfg, *args)
        ref = getattr(jspecs, name)(jcfg, *args)
        for k, w in ref.items():
            assert abstract[k].is_meta and tuple(abstract[k].shape) == w.shape
            assert str(abstract[k].dtype) == f"torch.{w.dtype}", k


def test_concrete_batches_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.reduced_model(tconfigs.get_bundle("gemma3-1b").model)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tspecs.train_batch(cfg, 2, 8, concrete=True)
    assert tspecs.train_batch(cfg, 2, 8)["tokens"].is_meta  # abstract: no device needed


def test_meshes(monkeypatch):
    pod1 = tmesh.make_production_mesh()
    pod2 = tmesh.make_production_mesh(multi_pod=True)
    assert pod1.axis_names == ("data", "model") and pod1.shape == {"data": 16, "model": 16}
    assert pod2.axis_names == ("pod", "data", "model") and pod2.size == 512
    assert {d.type for d in pod2.devices.flat} == {"meta"}
    local = tmesh.make_local_mesh(devices=[CPU] * 4)
    assert local.shape == {"data": 4, "model": 1}
    assert tmesh.make_local_mesh(2, 2, devices=[CPU] * 4).shape == {"data": 2, "model": 2}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        tmesh.make_local_mesh()


# ---------------------------------------------------------------------------
# lower_cell: meta runs of reduced configs
# ---------------------------------------------------------------------------


def _real_outputs(bundle, shape):
    """The same step on real CPU tensors (parameters from a seed)."""
    from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step

    cfg, B, S = bundle.model, shape.global_batch, shape.seq_len
    if shape.kind == "train":
        state = tts.init_train_state(0, cfg, bundle.train, device="cpu")
        batch = tspecs.train_batch(cfg, B, S, concrete=True, device="cpu")
        return tts.make_train_step(cfg, bundle.train)(state, batch)
    params = tmodels.init_params(0, cfg, device="cpu")
    with torch.no_grad():
        if shape.kind == "prefill":
            batch = tspecs.prefill_batch(cfg, B, S, concrete=True, device="cpu")
            return make_prefill_step(cfg)(params, batch)
        caches = tmodels.init_caches(B, S, cfg, device="cpu")
        batch = tspecs.decode_batch(cfg, B, S - 1, concrete=True, device="cpu")
        return make_decode_step(cfg)(params, batch, caches)


@pytest.mark.parametrize("arch", FAMILIES)
def test_lower_cell_meta_runs_are_shape_coherent(arch):
    """Each runnable small cell on the pod1 mesh: the meta run's outputs
    have the real run's shapes and dtypes, and its per-device bytes are the
    spec arithmetic over those outputs."""
    bundle = _reduced_bundle(arch)
    mesh = tmesh.make_production_mesh()
    for name in SMALL:
        if name in bundle.shape_skips:
            continue
        shape = _shape(name)
        cell = tcompile.lower_cell(bundle, shape, mesh)
        assert cell.aten_ops > 0 and cell.whole_program_live_bytes_peak > 0, name
        meta, real = _leaves(cell.outputs), _leaves(_real_outputs(bundle, shape))
        assert len(meta) == len(real) > 0, name
        for m, r in zip(meta, real):
            assert m.is_meta and m.shape == r.shape and m.dtype == r.dtype, name
        assert 0 < cell.output_size_in_bytes <= sum(t.numel() * t.element_size() for t in meta)
        assert 0 < cell.argument_size_in_bytes


@pytest.mark.parametrize("arch,name", [("gemma3-1b", "train_4k"), ("qwen2-vl-2b", "prefill_32k"),
                                       ("zamba2-7b", "decode_32k"),
                                       ("llama4-scout-17b-16e", "train_4k")])
def test_meta_tracker_counts_what_the_tracker_counts(arch, name):
    """The memoized dispatch makes the outputs the meta kernels make: the
    same aten ops and the same peak of live bytes, run twice (cold, warm)."""
    bundle = _reduced_bundle(arch)
    shape = _shape(name)
    cell = tcompile.lower_cell(bundle, shape, tmesh.make_production_mesh(), run_step=False)
    step = {"train": lambda: tts.make_train_step(bundle.model, bundle.train),
            "prefill": lambda: tcompile.make_prefill_step(bundle.model),
            "decode": lambda: tcompile.make_decode_step(bundle.model)}[shape.kind]()
    got = []
    for tracker in (Tracker(), tcompile.MetaTracker(), tcompile.MetaTracker()):
        with torch.no_grad() if shape.kind != "train" else torch.enable_grad(), tracker:
            out = step(*cell.args)
        got.append((tracker.ops, tracker.peak, [(t.shape, t.dtype, t.stride())
                                                for t in _leaves(out)]))
    assert got[0] == got[1] == got[2]


def test_lower_cell_reuses_meta_runs_only_where_nothing_changes():
    bundle = _reduced_bundle("gemma3-1b")
    runs = {}
    shape = _shape("decode_32k")
    a = tcompile.lower_cell(bundle, shape, tmesh.make_production_mesh(), runs=runs)
    b = tcompile.lower_cell(bundle, shape, tmesh.make_production_mesh(multi_pod=True), runs=runs)
    rep = dataclasses.replace(bundle, model=dataclasses.replace(
        bundle.model, serve_param_layout="replicated"))
    c = tcompile.lower_cell(rep, shape, tmesh.make_production_mesh(), runs=runs)
    assert not a.meta_run_reused and b.meta_run_reused and c.meta_run_reused
    assert a.aten_ops == b.aten_ops == c.aten_ops
    assert c.argument_size_in_bytes > a.argument_size_in_bytes  # weights replicated over data
    moe = _scout16(moe_impl="ep_shardmap")
    d = tcompile.lower_cell(moe, shape, tmesh.make_production_mesh(), runs=runs)
    e = tcompile.lower_cell(moe, shape, tmesh.make_production_mesh(multi_pod=True), runs=runs)
    assert not d.meta_run_reused and not e.meta_run_reused  # the mesh shapes the MoE impl


# ---------------------------------------------------------------------------
# run_cell and main
# ---------------------------------------------------------------------------


@pytest.fixture
def small_cells(monkeypatch):
    """``run_cell`` over the reduced bundles (llama4-scout with 16 experts,
    so its experts split over the 16-wide EP axis) at the SMALL shapes, the
    train cell at a global batch of 256 (every pod1 axis divides it)."""
    bundles = {a: _reduced_bundle(a) for a in tconfigs.list_archs()}
    bundles["llama4-scout-17b-16e"] = _scout16()
    shapes = {n: _shape(n) for n in SMALL}
    shapes["train_4k"] = tconfigs.ShapeConfig("train_4k", 8, 256, "train")
    monkeypatch.setattr(tconfigs, "get_bundle", bundles.__getitem__)
    monkeypatch.setattr(tconfigs, "SHAPES", shapes)


@pytest.mark.parametrize("optimized", [False, True])
def test_run_cell_writes_ok_records(small_cells, tmp_path, optimized):
    runs = {}
    for arch in ("gemma3-1b", "llama4-scout-17b-16e"):
        for name in ("train_4k", "decode_32k"):
            for mesh in ("pod1", "pod2"):
                assert tdryrun.run_cell(arch, name, mesh, str(tmp_path), False,
                                        optimized=optimized, runs=runs.setdefault(
                                            (arch, name), {}))
                rec = json.loads((tmp_path / f"{arch}__{name}__{mesh}.json").read_text())
                assert rec["status"] == "ok", rec.get("traceback")
                assert rec["mesh_shape"] == dict(tmesh.make_production_mesh(
                    multi_pod=mesh == "pod2").shape)
                assert rec["n_devices"] == (512 if mesh == "pod2" else 256)
                assert rec["collectives"] is None and "no HLO" in rec["collectives_note"]
                assert rec["flops"] is None and rec["bytes_accessed"] is None
                assert rec["aten_ops"] > 0 and rec["argument_size_in_bytes"] > 0
                assert rec["overrides"] == (tdryrun.optimized_overrides(arch, rec["kind"])
                                            if optimized else {})
    # under --optimized scout's train cell runs a2a on pod1 (the batch spans
    # data x model) and falls back to ep_shardmap on pod2; neither reuses
    recs = {m: json.loads((tmp_path / f"llama4-scout-17b-16e__train_4k__{m}.json").read_text())
            for m in ("pod1", "pod2")}
    assert recs["pod2"]["meta_run_reused"] is not optimized
    dense = json.loads((tmp_path / "gemma3-1b__train_4k__pod2.json").read_text())
    assert dense["meta_run_reused"]


def test_run_cell_writes_the_skip_reason(tmp_path, capsys):
    assert tdryrun.run_cell("hubert-xlarge", "decode_32k", "pod1", str(tmp_path), False)
    rec = json.loads((tmp_path / "hubert-xlarge__decode_32k__pod1.json").read_text())
    reason = tconfigs.get_bundle("hubert-xlarge").shape_skips["decode_32k"]
    assert rec == {"arch": "hubert-xlarge", "shape": "decode_32k", "mesh": "pod1",
                   "status": "skipped", "reason": reason}
    assert "[skip-cell]" in capsys.readouterr().out


def test_main_runs_and_resumes(tmp_path, capsys):
    argv = ["--arch", "gemma3-1b", "--shape", "decode_32k", "--mesh", "pod1",
            "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        tdryrun.main(argv)
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "[ok] gemma3-1b x decode_32k x pod1" in out and "DRYRUN PASS" in out
    with pytest.raises(SystemExit):
        tdryrun.main(argv)
    assert "[skip]" in capsys.readouterr().out


def test_main_default_output_directories(monkeypatch, tmp_path):
    seen = []
    monkeypatch.setattr(tdryrun, "run_groups", lambda tasks, workers: seen.append(
        {t[3] for t in tasks}.pop()) or True)
    monkeypatch.chdir(tmp_path)
    for argv, want in (([], "results/dryrun_torch"), (["--optimized"], "results/dryrun_torch_opt")):
        with pytest.raises(SystemExit):
            tdryrun.main(argv)
        assert seen[-1] == want and (tmp_path / want).is_dir()


@pytest.mark.parametrize("arch", tconfigs.list_archs())
def test_optimized_overrides_match_the_reference(arch):
    for kind in ("train", "prefill", "decode"):
        assert tdryrun.optimized_overrides(arch, kind) == jdryrun.optimized_overrides(arch, kind)


# ---------------------------------------------------------------------------
# the HLO collective parser
# ---------------------------------------------------------------------------


def _jax_hlo_texts():
    """HLO text jax emits here: a jitted shard_map whose body loops 7 times
    over a psum, lowered (computations without signatures) and compiled."""
    mesh = jax.make_mesh((1,), ("i",), devices=jax.devices()[:1])

    def body(x):
        return jax.lax.fori_loop(0, 7, lambda k, c: jax.lax.psum(c, "i") * 0.5, x)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=JP("i"), out_specs=JP("i"),
                              check_vma=False))
    lowered = f.lower(jnp.ones(8))
    return [lowered.as_text(dialect="hlo"), lowered.compile().as_text()]


def test_parse_collectives_matches_the_reference():
    texts = [FAKE_HLO, *_jax_hlo_texts()]
    for text in texts:
        assert tdryrun.parse_collectives(text) == jdryrun.parse_collectives(text)
        comps = tdryrun._split_computations(text)
        assert comps == jdryrun._split_computations(text)
        for lines in comps.values():
            assert tdryrun._trip_count(lines) == jdryrun._trip_count(lines)
        for line in text.splitlines():
            assert tdryrun._line_collective_bytes(line) == jdryrun._line_collective_bytes(line)
    assert tdryrun.parse_collectives(texts[0])["total_bytes"] == 512 * 12 + 256 + 64 * 12
    compiled = tdryrun.parse_collectives(texts[2])
    assert compiled["counts"] == {"all-reduce": 7} and compiled["total_bytes"] == 7 * 8 * 4 * 2
    assert tdryrun.DTYPE_BYTES == jdryrun.DTYPE_BYTES
