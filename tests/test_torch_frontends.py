"""Port parity of the frontend families (CPU): hubert-xlarge (audio frames,
encoder-only, masked-prediction CE) and qwen2-vl-2b (a vision patch prefix
and (3, B, S) M-RoPE grids), against the JAX package at the reduced sizes.

Inputs come from numpy with the seed each case states (batches from the
reference's ``SyntheticStream``, whose bytes the port's equals); parameters
are the reference's ``init_params`` handed over with ``params_from_jax``,
caches with ``caches_from_jax``, training states with
``train_state_from_jax``. Bars (f32): logits and layer outputs rtol = atol =
1e-4, caches 1e-5, greedy tokens equal; the loss within 1e-6 relative and
every gradient leaf within 2e-5 of its largest |entry|; one
``make_train_step`` at ``tests/test_torch_train.py``'s bars (metrics 1e-5,
lr within 2 ulps, parameters within 0.05 of the lr, moments within 1e-4 of a
leaf's largest, or one bf16 rounding for bf16 moments) — but for an entry
whose gradient is within ``ADAM_NEAR_EPS`` times Adam's eps of 0: its first
step, lr·g/(|g| + eps), turns the last bits of such a gradient (1e-7 of its
leaf's largest, within the gradient bar) into any part of the lr. The
reference skips its own prefill/decode consistency check for the vision
family (``tests/test_archs.py``), so the VLM decode is held against the
reference's ``forward_decode`` step for step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JStream
from repro.models import model as jmodel
from repro.runtime import train_step as jts
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.models import model as tmodel
from repro_torch.runtime import train_step as tts

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
F32_LOSS_TOL = 1e-6
F32_GRAD_TOL = 2e-5
STEP_METRIC_RTOL = 1e-5
LR_ULPS = 2
STEP_PARAM_LR = 0.05
STEP_MOMENT_TOL = {"float32": 1e-4, "bfloat16": 2 ** -7}
ADAM_NEAR_EPS = 10
FAMILIES = ["hubert-xlarge", "qwen2-vl-2b"]
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **overrides):
    j = dataclasses.replace(jconfigs.reduced_model(jconfigs.get_bundle(arch).model), **overrides)
    t = dataclasses.replace(tconfigs.reduced_model(tconfigs.get_bundle(arch).model), **overrides)
    return j, t


_MODELS = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params), the port's
    handed over from the reference's PRNGKey(0) draw."""
    if arch not in _MODELS:
        jcfg, tcfg = _configs(arch)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tp = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[arch] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch]


def _batch(jcfg, seed, seq=S, batch=B):
    """The reference stream's batch (numpy) at step 0 of ``seed``; vision
    batches get real (t, h, w) grids: the patch prefix on a 2-D grid at t=0,
    the text after it at t=h=w."""
    out = JStream(JDataConfig(seq_len=seq, global_batch=batch, seed=seed), jcfg).batch(0)
    if jcfg.frontend == "vision":
        nv = out["patches"].shape[1]
        side = int(np.ceil(np.sqrt(nv)))
        i = np.arange(nv)
        grid = np.stack([np.zeros(nv), i // side, i % side]).astype(np.int32)
        text = np.broadcast_to(side + np.arange(seq - nv, dtype=np.int32), (3, seq - nv))
        pos = np.concatenate([grid, text], axis=1)
        out["positions"] = np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, seq)))
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, dtype=np.float32)


def _assert_caches(tc, jc, tol=CACHE_TOL):
    assert set(tc) == set(jc)
    for group in jc:
        assert set(tc[group]) == set(jc[group])
        for p, jkv in jc[group].items():
            tkv = tc[group][p]
            assert type(tkv).__name__ == type(jkv).__name__ and tkv._fields == jkv._fields
            for f, a, b in zip(jkv._fields, tkv, jkv):
                if np.asarray(b).dtype.kind == "i":
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
                else:
                    np.testing.assert_allclose(_np(a), _np(b), err_msg=f"{group}/{p}/{f}", **tol)


def _flat(tree) -> dict:
    """{leaf name: float64 numpy} of either package's tree."""
    return {name: (leaf.detach().double().numpy() if isinstance(leaf, torch.Tensor)
                   else np.asarray(leaf, dtype=np.float64))
            for name, leaf in tts.named_leaves(tree)}


# ---------------------------------------------------------------------------
# init and the handover
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_tree_matches_the_reference(arch):
    jcfg, tcfg, jp, _ = _model(arch)
    jflat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jp))[0]
    tflat = jax.tree_util.tree_flatten_with_path(tmodels.init_params(3, tcfg, device="cpu"))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [jax.tree_util.keystr(p)
                                                           for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == tuple(b.shape) and str(b.dtype) == f"torch.{a.dtype}", path
    top = list(tmodels.init_params(3, tcfg, device="cpu"))
    assert top == list(jp)  # the reference's key order
    want = {"hubert-xlarge": ["frontend_proj", "head"],
            "qwen2-vl-2b": ["embed", "vision_proj"]}[arch]
    assert top[:2] == want


# ---------------------------------------------------------------------------
# the frontends' inputs and logits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_embed_inputs_and_logits(arch):
    """Seed 31: the audio frames / vision prefix and positions, and the
    logits of a hidden state (the audio ``head``, the tied vision table)."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg, 31)
    jx, jpos = jmodel._embed_inputs(jp, _j(batch), jcfg)
    tx, tpos = tmodel._embed_inputs(tp, _t(batch), tcfg)
    np.testing.assert_allclose(_np(tx), _np(jx), **TOL)
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tx.shape == (B, S, tcfg.d_model) and tpos.shape == ((3, B, S) if tcfg.frontend ==
                                                                 "vision" else (B, S))
    h = np.random.default_rng(32).normal(size=(B, 5, tcfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(_np(tmodel._logits(tp, torch.from_numpy(h), tcfg)),
                               _np(jmodel._logits(jp, jnp.asarray(h), jcfg)), **TOL)


@pytest.mark.parametrize("arch,missing", [("hubert-xlarge", "frames"),
                                          ("qwen2-vl-2b", "patches"),
                                          ("qwen2-vl-2b", "positions")])
def test_a_frontend_without_its_input_raises(arch, missing):
    """No quiet fallback to tokens: a batch without the frontend's input
    raises, naming it (the reference fails on the missing key too)."""
    jcfg, tcfg, _, tp = _model(arch)
    batch = _t(_batch(jcfg, 33))
    del batch[missing]
    batch.setdefault("tokens", torch.zeros((B, S), dtype=torch.int32))
    for call in (lambda: tmodels.forward_prefill(tp, batch, tcfg),
                 lambda: tmodels.forward_train(tp, batch, tcfg)):
        with pytest.raises(ValueError, match=f"needs batch\\['{missing}'\\]"):
            call()


def test_encoder_only_has_no_decode():
    _, tcfg, _, tp = _model("hubert-xlarge")
    zeros = torch.zeros((B,), dtype=torch.int32)
    step = {"token": zeros, "pos": zeros}
    for call in (lambda: tmodels.init_caches(B, S, tcfg, device="cpu"),
                 lambda: tmodels.forward_decode(tp, step, {}, tcfg)):
        with pytest.raises(ValueError, match="encoder-only"):
            call()


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode(arch):
    """Seed 34: the prefill (hubert: full (B, S, V) logits and no caches),
    then four greedy steps, each package on its own tokens (equal at every
    step) and its own caches."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg, 34)
    clen = None if jcfg.encoder_only else S + 8
    jl, jc = jmodels.forward_prefill(jp, _j(batch), jcfg, cache_len=clen)
    tl, tc = tmodels.forward_prefill(tp, _t(batch), tcfg, cache_len=clen)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    if jcfg.encoder_only:
        assert tl.shape == (B, S, tcfg.vocab_size) and tc is None and jc is None
        return
    assert tl.shape == (B, tcfg.vocab_size)
    _assert_caches(tc, jax.tree.map(np.asarray, jc))
    jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1).to(torch.int32)
    for i in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B,), S + i, np.int32)
        jl, jt, jc = jmodels.forward_decode(jp, {"token": jt, "pos": jnp.asarray(pos)}, jc, jcfg)
        tl, tt, tc = tmodels.forward_decode(tp, {"token": tt, "pos": torch.from_numpy(pos)}, tc,
                                            tcfg)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        _assert_caches(tc, jax.tree.map(np.asarray, jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_loss_and_grads_match_the_reference(arch):
    """Seed 35: the jitted reference's loss and gradients."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg, 35)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodels.forward_train(p, b, jcfg)))(jp, _j(batch))
    loss, grads = tts._value_and_grad(tp, _t(batch), tcfg)
    assert abs(float(loss) - float(jloss)) <= F32_LOSS_TOL * abs(float(jloss))
    want, got = _flat(jax.tree.map(np.asarray, jgrads)), _flat(grads)
    assert list(want) == list(got)
    for name in want:
        scale = np.max(np.abs(want[name]))
        err = np.max(np.abs(got[name] - want[name]))
        assert err <= F32_GRAD_TOL * scale, (name, err, scale)


@pytest.mark.parametrize("arch", FAMILIES)
def test_make_train_step_matches_the_reference(arch):
    """One step of the reference's jitted step and the port's from the same
    state (handed over) on the same batch (seed 36)."""
    jcfg, tcfg = _configs(arch)
    trc = dataclasses.replace(jconfigs.get_bundle(arch).train, warmup_steps=2, total_steps=10)
    ttrc = tconfigs.TrainConfig(**dataclasses.asdict(trc))
    jstate = jts.init_train_state(jax.random.PRNGKey(3), jcfg, trc)
    tstate = tmodels.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, ttrc,
                                          device="cpu")
    batch = _batch(jcfg, 36, batch=4)
    jstate, jm = jax.jit(jts.make_train_step(jcfg, trc))(jstate, _j(batch))
    tstate, tm = tts.make_train_step(tcfg, ttrc)(tstate, _t(batch))
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_METRIC_RTOL, err_msg=k)
    np.testing.assert_array_max_ulp(tm["lr"].numpy(), np.asarray(jm["lr"]), maxulp=LR_ULPS)
    want, got = _flat(jax.tree.map(np.asarray, jstate)), _flat(tstate)
    assert list(want) == list(got)
    for k in want:
        past = np.abs(got[k] - want[k]) > (
            STEP_PARAM_LR * float(jm["lr"]) if k.startswith("params/")
            else STEP_MOMENT_TOL[trc.optimizer_dtype] * np.max(np.abs(want[k])))
        if k.startswith("params/"):  # |g| of the step, from the reference's v
            g = np.sqrt(want["opt/v/" + k[len("params/"):]] / (1 - trc.beta2))
            past &= g >= ADAM_NEAR_EPS * trc.eps
        assert not past.any(), f"{k}: {int(past.sum())} of {past.size} entries past the bar"


# ---------------------------------------------------------------------------
# the launchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,need", [("hubert-xlarge", "audio frames"),
                                       ("qwen2-vl-2b", "image patches")])
def test_serve_lm_refuses_a_frontend_model(arch, need):
    """``serve --mode lm`` feeds token prompts only (as the reference's,
    which fails on the missing frames/patches): a clear error, before any
    parameter is drawn."""
    from repro_torch.launch import serve

    with pytest.raises(ValueError, match=f"token prompts only; {arch} takes {need}"):
        serve.main(["--mode", "lm", "--arch", arch, "--device", "cpu"])


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_runs_reduced(arch, tmp_path, capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                         "--seq-len", "32", "--global-batch", "2", "--ckpt-dir",
                         str(tmp_path / "ck")])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert f"[train] arch={arch} reduced=True steps=3" in capsys.readouterr().out
