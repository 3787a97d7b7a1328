"""Fault tolerance of the port's training (CPU): the contracts of
``tests/test_fault.py`` on ``repro_torch.runtime.fault`` — restart after an
injected failure bit-equal to the uninterrupted run, with sync and async
checkpoints; replay from the step-0 commit; the async checkpointer's flush
on failure and its save errors on the clean path — and training
checkpoints crossing between the packages.

Bars: the port against itself, bit for bit. Across packages: a training
checkpoint written by either package restores in the other leaf for leaf,
and re-saved there its decompressed payload is the same bytes. The port
resuming the reference's step-5 checkpoint reaches the reference's 10-step
state (f32 compute) with loss within ``RESUME_LOSS_RTOL`` and lr within
``LR_ULPS`` f32 ulps at every step (XLA contracts the jitted schedule's
multiply-adds and turns its divisions by constants into products),
parameters within ``RESUME_PARAM_LR`` of the learning rates summed over the
resumed steps (Adam turns the last-bit differences of a gradient entry near
0 into a visible part of one step) and each moment leaf within
``RESUME_MOMENT_TOL`` of its largest |entry|.
"""

import dataclasses
import os
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ckpt as jckpt
from repro.configs import get_bundle as jget_bundle
from repro.configs import reduced_model as jreduced
from repro.data.pipeline import DataConfig as JDataConfig
from repro.runtime import fault as jfault
from repro.runtime import train_step as jts
from repro_torch import ckpt
from repro_torch.ckpt import checkpoint as ckpt_mod
from repro_torch.configs import get_bundle, reduced_model
from repro_torch.data import DataConfig
from repro_torch.models import train_state_from_jax
from repro_torch.runtime import train_step as tts
from repro_torch.runtime.fault import (
    SimulatedFailure,
    StragglerMonitor,
    restore_train_state,
    run_with_restarts,
    train_loop,
)

RESUME_LOSS_RTOL = 1e-5
RESUME_PARAM_LR = 0.05
RESUME_MOMENT_TOL = 1e-4
LR_ULPS = 2
DCFG = DataConfig(seq_len=32, global_batch=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny(get, reduce, **train):
    bundle = get("gemma3-1b")
    mcfg = dataclasses.replace(reduce(bundle.model), n_units=1, n_layers=8,
                               tail=("local", "local"))
    tcfg = dataclasses.replace(bundle.train, total_steps=20, warmup_steps=2, **train)
    return dataclasses.replace(bundle, model=mcfg, train=tcfg)


@pytest.fixture()
def tiny_bundle():
    return _tiny(get_bundle, reduced_model)


def _run(bundle, steps, d, **kw):
    return train_loop(bundle, DCFG, steps, str(d), device="cpu", **kw)


def _assert_same_state(a, b):
    la, lb = tts.train_state_leaves(a), tts.train_state_leaves(b)
    assert list(la) == list(lb)
    for k in la:
        assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_restart_reproduces_uninterrupted_run(tiny_bundle, tmp_path, async_ckpt):
    """Kill at step 7 (after the commit at 5), restart: bit-equal to a clean
    10-step run."""
    clean = _run(tiny_bundle, 10, tmp_path / "clean", ckpt_every=5)
    faulty = run_with_restarts(tiny_bundle, DCFG, 10, str(tmp_path / "faulty"), failures=(7,),
                               ckpt_every=5, async_ckpt=async_ckpt, device="cpu")
    _assert_same_state(clean, faulty)
    assert int(faulty.opt.step) == 10 and ckpt.latest_step(str(tmp_path / "faulty")) == 10


def test_failure_without_commit_replays_steps(tiny_bundle, tmp_path):
    """A failure before any post-step commit resumes from step 0 and still
    reaches the same state (the data is a pure function of the step)."""
    d = tmp_path / "c"
    with pytest.raises(SimulatedFailure):
        _run(tiny_bundle, 10, d, ckpt_every=100, fail_at=3)
    assert ckpt.latest_step(str(d)) == 0  # only the step-0 bootstrap commit
    resumed = _run(tiny_bundle, 6, d, ckpt_every=100)
    clean = _run(tiny_bundle, 6, tmp_path / "clean", ckpt_every=100)
    _assert_same_state(resumed, clean)


def test_async_checkpointer_equivalent(tiny_bundle, tmp_path):
    sync = _run(tiny_bundle, 6, tmp_path / "s", ckpt_every=2)
    asyn = _run(tiny_bundle, 6, tmp_path / "a", ckpt_every=2, async_ckpt=True)
    _assert_same_state(sync, asyn)
    assert ckpt.latest_step(str(tmp_path / "a")) == 6
    for step in (0, 2, 4, 6):  # every commit of the two runs holds the same leaves
        names = list(tts.train_state_leaves(sync))
        a = ckpt.restore_checkpoint(str(tmp_path / "s"), step, names)
        b = ckpt.restore_checkpoint(str(tmp_path / "a"), step, names)
        for k in names:
            assert _bits(a[k]) == _bits(b[k]), (step, k)


def _bits(leaf):
    return leaf.bits.tobytes() if isinstance(leaf, ckpt.Bits) else leaf.tobytes()


def test_metrics_and_straggler_telemetry(tiny_bundle, tmp_path):
    seen = []
    _run(tiny_bundle, 3, tmp_path, ckpt_every=100,
         on_metrics=lambda step, m: seen.append((step, m)))
    assert [s for s, _ in seen] == [1, 2, 3]
    for _, m in seen:
        assert set(m) == {"loss", "grad_norm", "lr"} and all(np.isfinite(list(m.values())))
    mon = StragglerMonitor(alpha=0.5, k_sigma=3.0)
    for s in range(8):
        assert not mon.observe(s, 0.10 + 0.001 * (s % 2))
    assert mon.observe(8, 1.0) and mon.flagged[0][0] == 8


@pytest.mark.parametrize("mode", ["bf16", "int8_ef"])
def test_grad_compression_modes_train_and_restart(tiny_bundle, tmp_path, mode):
    """bf16 and int8+EF compression (microbatch 2) train without NaNs, and
    a restart (the int8 residuals go through the checkpoint) is bit-equal."""
    b = dataclasses.replace(tiny_bundle, train=dataclasses.replace(
        tiny_bundle.train, grad_compression=mode, microbatch=2, optimizer_dtype="bfloat16"))
    clean = _run(b, 4, tmp_path / "clean", ckpt_every=2)
    for leaf in tts.tree_leaves(clean.params):
        assert bool(torch.isfinite(leaf).all()), mode
    faulty = run_with_restarts(b, DCFG, 4, str(tmp_path / "faulty"), failures=(3,),
                               ckpt_every=2, device="cpu")
    _assert_same_state(clean, faulty)
    assert (clean.opt.ef is not None) == (mode == "int8_ef")


def test_restore_refuses_another_configurations_checkpoint(tiny_bundle, tmp_path):
    """A directory from another configuration raises naming the leaf, and
    nothing is loaded; so does one whose compression adds leaves."""
    d = str(tmp_path)
    _run(tiny_bundle, 2, d, ckpt_every=100)
    wider = dataclasses.replace(tiny_bundle, model=dataclasses.replace(tiny_bundle.model,
                                                                       d_ff=96))
    with pytest.raises(ValueError, match=r"params/tail/p0/ffn/w_down/w: \(128, 64\)"):
        _run(wider, 4, d)
    assert ckpt.latest_step(d) == 2  # the stale run wrote nothing
    compressed = dataclasses.replace(tiny_bundle, train=dataclasses.replace(
        tiny_bundle.train, grad_compression="int8_ef", microbatch=2))
    with pytest.raises(KeyError, match="opt/ef/"):
        _run(compressed, 4, d)
    template = tts.init_train_state(0, tiny_bundle.model, tiny_bundle.train, device="cpu")
    leaves = ckpt.restore_checkpoint(d, 2, list(tts.train_state_leaves(template)))
    leaves["opt/step"] = leaves["opt/step"].astype(np.int64)
    with pytest.raises(ValueError, match="opt/step"):
        tts.train_state_from_leaves(leaves, template, device="cpu")


def test_checkpoint_roundtrip_dtypes(tmp_path):
    leaves = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
              "b/c": torch.ones(4, dtype=torch.bfloat16) * 1.5,
              "scalar": torch.tensor(7, dtype=torch.int32)}
    ckpt.save_checkpoint(str(tmp_path), 3, {k: ckpt.host_copy(v) for k, v in leaves.items()})
    assert ckpt.latest_step(str(tmp_path)) == 3
    template = tts.TrainState(params={"a": leaves["a"], "b": {"c": leaves["b/c"]}},
                              opt=None)
    back = ckpt.restore_checkpoint(str(tmp_path), 3, ["a", "b/c", "scalar"])
    assert isinstance(back["b/c"], ckpt.Bits) and back["scalar"].shape == ()
    got = tts.train_state_from_leaves({"params/a": back["a"], "params/b/c": back["b/c"]},
                                      template, device="cpu")
    assert torch.equal(got.params["a"], leaves["a"])
    assert got.params["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(got.params["b"]["c"], leaves["b/c"])


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    ckpt.save_checkpoint(d, 5, {"x": np.zeros((2,), np.float32)})
    os.makedirs(os.path.join(d, "step_000000010"))  # a crash mid-write at step 10
    assert ckpt.latest_step(d) == 5


# --- the async checkpointer (context manager: flush on exception) ----------


def _slow_save(monkeypatch, seconds):
    real = ckpt_mod.save_checkpoint
    monkeypatch.setattr(ckpt_mod, "save_checkpoint",
                        lambda *a, **k: (time.sleep(seconds), real(*a, **k))[1])


def test_async_checkpointer_flushes_in_flight_save_on_failure(tmp_path, monkeypatch):
    """A failure raised while a save is in flight does not lose it:
    ``__exit__`` joins the writer, so the restart sees the commit."""
    _slow_save(monkeypatch, 0.3)
    d = str(tmp_path)
    with pytest.raises(SimulatedFailure):
        with ckpt.AsyncCheckpointer(d) as saver:
            saver.save(7, {"x": torch.arange(3)})
            raise SimulatedFailure("die with a save in flight")
    assert ckpt.latest_step(d) == 7


def test_async_checkpointer_exit_clean_path_raises_save_errors(tmp_path):
    """On a clean exit a failed save propagates; while another exception
    unwinds, it does not mask it."""
    bad = os.path.join(str(tmp_path), "file")  # its parent is a file: the save fails
    with open(bad, "w") as f:
        f.write("x")
    with pytest.raises(OSError):
        with ckpt.AsyncCheckpointer(os.path.join(bad, "sub")) as saver:
            saver.save(1, {"x": torch.zeros(1)})
    with pytest.raises(SimulatedFailure):
        with ckpt.AsyncCheckpointer(os.path.join(bad, "sub")) as saver:
            saver.save(1, {"x": torch.zeros(1)})
            raise SimulatedFailure("primary")


def test_async_save_takes_its_host_copy_before_returning(tmp_path, monkeypatch):
    """On the CPU ``tensor.cpu()`` is the tensor itself: a write after
    ``save()`` returns must not reach the checkpoint."""
    _slow_save(monkeypatch, 0.2)
    t = torch.arange(4, dtype=torch.float32)
    b = torch.ones(2, dtype=torch.bfloat16)
    with ckpt.AsyncCheckpointer(str(tmp_path)) as saver:
        saver.save(1, {"t": t, "b": b})
        t.add_(100.0)
        b.mul_(3.0)
    back = ckpt.restore_checkpoint(str(tmp_path), 1, ["t", "b"])
    np.testing.assert_array_equal(back["t"], np.arange(4, dtype=np.float32))
    assert back["b"].bits.tobytes() == torch.ones(2, dtype=torch.bfloat16).view(
        torch.int16).numpy().tobytes()


def test_train_loop_failure_with_async_ckpt_commits_in_flight_save(tiny_bundle, tmp_path,
                                                                   monkeypatch):
    """``train_loop`` with async checkpoints dies right after handing the
    step-5 save to the writer; the restart resumes from step 5 and equals
    the clean run bit for bit."""
    _slow_save(monkeypatch, 0.2)
    d = tmp_path / "faulty"
    with pytest.raises(SimulatedFailure):
        _run(tiny_bundle, 10, d, ckpt_every=5, fail_at=6, async_ckpt=True)
    assert ckpt.latest_step(str(d)) == 5
    faulty = run_with_restarts(tiny_bundle, DCFG, 10, str(d), failures=(), ckpt_every=5,
                               async_ckpt=True, device="cpu")
    clean = _run(tiny_bundle, 10, tmp_path / "clean", ckpt_every=5)
    _assert_same_state(faulty, clean)


def test_train_loop_needs_the_card_by_default(tiny_bundle, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        train_loop(tiny_bundle, DCFG, 1, str(tmp_path))


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------


def _payload(directory, step) -> bytes:
    """The decompressed msgpack payload of one committed step."""
    step_dir = os.path.join(directory, f"step_{step:09d}")
    (name,) = [n for n in os.listdir(step_dir) if n.startswith("shard_0")]
    with open(os.path.join(step_dir, name), "rb") as f:
        return ckpt_mod._decompress(f.read(), ckpt_mod._zstd())


def test_training_checkpoints_cross_between_the_packages(tmp_path):
    """A reference training state with bf16 moments and int8 error feedback
    (its moments and residuals filled from a numpy seed, step 7): saved by
    the reference, restored by the port and saved again, the payload is the
    same bytes; saved by the port, restored and saved by the reference,
    too."""
    jb = _tiny(jget_bundle, jreduced, optimizer_dtype="bfloat16", grad_compression="int8_ef",
               microbatch=2)
    tb = _tiny(get_bundle, reduced_model, optimizer_dtype="bfloat16",
               grad_compression="int8_ef", microbatch=2)
    state = jts.init_train_state(jax.random.PRNGKey(5), jb.model, jb.train)
    rs = np.random.default_rng(9)
    fill = lambda dt: lambda a: jnp.asarray(rs.normal(size=a.shape).astype(np.float32), dt)
    state = state._replace(opt=state.opt._replace(
        step=jnp.asarray(7, jnp.int32), m=jax.tree.map(fill(jnp.bfloat16), state.opt.m),
        v=jax.tree.map(fill(jnp.bfloat16), state.opt.v),
        ef=jax.tree.map(fill(jnp.float32), state.opt.ef)))
    ref_dir, port_dir, back_dir = (str(tmp_path / n) for n in ("ref", "port", "back"))
    jckpt.save_checkpoint(ref_dir, 7, state)

    template = tts.init_train_state(0, tb.model, tb.train, device="cpu")
    restored = restore_train_state(ref_dir, 7, template)
    handed = train_state_from_jax(jax.tree.map(np.asarray, state), tb.model, tb.train,
                                  device="cpu")
    _assert_same_state(restored, handed)
    assert restored.opt.m["embed"]["table"].dtype == torch.bfloat16
    assert int(restored.opt.step) == 7
    ckpt.save_checkpoint(port_dir, 7, {k: ckpt.host_copy(v)
                                       for k, v in tts.train_state_leaves(restored).items()})
    assert _payload(port_dir, 7) == _payload(ref_dir, 7)

    back = jckpt.restore_checkpoint(port_dir, 7, state)
    jckpt.save_checkpoint(back_dir, 7, back)
    assert _payload(back_dir, 7) == _payload(port_dir, 7)


def test_port_resumes_the_references_run(tmp_path):
    """The reference trains 10 steps (commits at 5 and 10); the port resumes
    its step-5 commit and reaches its 10-step state within the stated bars."""
    jb = _tiny(jget_bundle, jreduced)
    tb = _tiny(get_bundle, reduced_model)
    ref_losses, port_losses = {}, {}
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    ref = jfault.train_loop(jb, JDataConfig(seq_len=32, global_batch=2), 10, str(ref_dir),
                            ckpt_every=5, on_metrics=lambda s, m: ref_losses.update({s: m}))
    os.makedirs(port_dir)
    shutil.copytree(ref_dir / "step_000000005", port_dir / "step_000000005")
    port = train_loop(tb, DCFG, 10, str(port_dir), ckpt_every=5, device="cpu",
                      on_metrics=lambda s, m: port_losses.update({s: m}))
    assert sorted(port_losses) == list(range(6, 11))
    lr_sum = 0.0
    for s in range(6, 11):
        np.testing.assert_allclose(port_losses[s]["loss"], ref_losses[s]["loss"],
                                   rtol=RESUME_LOSS_RTOL)
        np.testing.assert_array_max_ulp(np.float32(port_losses[s]["lr"]),
                                        np.float32(ref_losses[s]["lr"]), maxulp=LR_ULPS)
        lr_sum += ref_losses[s]["lr"]
    want = dict(tts.named_leaves(jax.tree.map(np.asarray, ref)))
    got = tts.train_state_leaves(port)
    assert list(want) == list(got)
    for k, w in want.items():
        w, g = np.asarray(w, np.float64), got[k].double().numpy()
        bar = RESUME_PARAM_LR * lr_sum if k.startswith("params/") else (
            RESUME_MOMENT_TOL * np.max(np.abs(w)))
        assert np.max(np.abs(g - w)) <= bar, (k, np.max(np.abs(g - w)), bar)
