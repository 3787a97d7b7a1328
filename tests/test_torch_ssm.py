"""Port parity of the Mamba2 families (CPU): mamba2-2.7b (attention-free SSD)
and zamba2-7b (Mamba2 layers with one shared attention+MLP block whose
occurrences keep their own KV caches), and ``models.ssm`` alone, against the
JAX package at the reduced sizes (d_model 64, d_state 16, head_dim 16, chunk
16).

Inputs come from numpy with the seed each case states (batches from the
reference's ``SyntheticStream``); parameters are the reference's
``init_params`` (``init_mamba2``) handed over with ``params_from_jax``,
caches with ``caches_from_jax``, training states with
``train_state_from_jax``. Bars (f32): ``mamba2_sequence`` and
``mamba2_decode`` outputs within rtol = atol = 1e-5, the cache's conv tail
within 1e-5 and its state within 1e-5 of its largest |entry|, at S below the
chunk, at two chunks and on the pad path (two chunks and 5); logits rtol =
atol = 1e-4, caches 1e-5, greedy tokens equal; the loss within 1e-6 relative
and every gradient leaf within 2e-5 of its largest |entry|; one
``make_train_step`` at ``tests/test_torch_train.py``'s bars (metrics 1e-5,
lr within 2 ulps, parameters within 0.05 of the lr, moments within 1e-4 of a
leaf's largest) — but for an entry whose gradient is within
``ADAM_NEAR_EPS`` times Adam's eps of 0: its first step, lr·g/(|g| + eps),
turns the last bits of such a gradient (1e-7 of its leaf's largest, within
the gradient bar) into any part of the lr. The port's own prefill/decode
consistency is held at the reference's bar, 2e-2.
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
from repro.models import ssm as jssm
from repro.runtime import train_step as jts
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.models import ssm as tssm
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
FAMILIES = ["mamba2-2.7b", "zamba2-7b"]
SSM_TOL = dict(rtol=1e-5, atol=1e-5)
CONSISTENCY_TOL = 2e-2  # the reference's prefill/decode bar (tests/test_archs.py)
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
    """The reference stream's token batch (numpy) at step 0 of ``seed``."""
    return JStream(JDataConfig(seq_len=seq, global_batch=batch, seed=seed), jcfg).batch(0)


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
    if arch == "zamba2-7b":  # one shared block; its unit slots hold no weights
        tree = tmodels.init_params(3, tcfg, device="cpu")
        assert tree["units"]["p5"] == {} and set(tree["shared_block"]) == {"ln1", "attn",
                                                                            "ln2", "ffn"}


# ---------------------------------------------------------------------------
# models.ssm
# ---------------------------------------------------------------------------


def _mamba(seed):
    """The reduced mamba2's block (reference ``init_mamba2``, handed over)."""
    jcfg, tcfg = _configs("mamba2-2.7b")
    jp = jssm.init_mamba2(jax.random.PRNGKey(seed), jcfg, jcfg.ssm, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _assert_mamba_cache(tc, jc):
    np.testing.assert_allclose(_np(tc.conv), _np(jc.conv), **SSM_TOL)  # a product's output
    state = np.asarray(jc.state)
    assert tc.state.dtype == torch.float32 and tc.state.shape == state.shape
    assert np.max(np.abs(_np(tc.state) - state)) <= 1e-5 * np.max(np.abs(state))


@pytest.mark.parametrize("seq", [8, 32, 37])
def test_mamba2_sequence_and_decode(seq):
    """Seed 51: ``mamba2_sequence`` at S below the chunk (Q = S), two chunks
    and two chunks and 5 (the pad path), with and without its cache; then
    four ``mamba2_decode`` steps from that cache."""
    jcfg, tcfg, jp, tp = _mamba(51)
    rs = np.random.default_rng(51 + seq)
    u = rs.normal(size=(B, seq, jcfg.d_model)).astype(np.float32)
    want = jssm.mamba2_sequence(jp, jnp.asarray(u), jcfg, jcfg.ssm)
    got = tssm.mamba2_sequence(tp, torch.from_numpy(u), tcfg, tcfg.ssm)
    np.testing.assert_allclose(_np(got), _np(want), **SSM_TOL)
    jout, jc = jssm.mamba2_sequence(jp, jnp.asarray(u), jcfg, jcfg.ssm, return_cache=True)
    tout, tc = tssm.mamba2_sequence(tp, torch.from_numpy(u), tcfg, tcfg.ssm, return_cache=True)
    assert torch.equal(tout, got)
    assert tc.conv.shape == (B, tcfg.ssm.d_conv - 1, tssm._dims(tcfg, tcfg.ssm)[2])
    _assert_mamba_cache(tc, jc)
    for i in range(4):
        x = rs.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
        jo, jc = jssm.mamba2_decode(jp, jnp.asarray(x), jc, jcfg, jcfg.ssm)
        conv_before = tc.conv.clone()
        to, tc2 = tssm.mamba2_decode(tp, torch.from_numpy(x), tc, tcfg, tcfg.ssm)
        assert torch.equal(tc.conv, conv_before)  # the given cache is left as it was
        tc = tc2
        np.testing.assert_allclose(_np(to), _np(jo), **SSM_TOL)
        _assert_mamba_cache(tc, jc)


def test_mamba2_conv_tail_is_the_last_inputs():
    """The prefill's conv cache is the last d_conv - 1 inputs of the padded
    sequence: at S=2 < d_conv - 1 it keeps a zero row of the padding."""
    _, tcfg, _, tp = _mamba(52)
    u = torch.from_numpy(np.random.default_rng(52).normal(size=(B, 2, tcfg.d_model))
                         .astype(np.float32))
    _, cache = tssm.mamba2_sequence(tp, u, tcfg, tcfg.ssm, return_cache=True)
    xBC = tssm._split_proj(u @ tp["in_proj"]["w"], tcfg, tcfg.ssm)[1]
    assert torch.equal(cache.conv[:, 0], torch.zeros_like(cache.conv[:, 0]))
    assert torch.equal(cache.conv[:, 1:], xBC)


def test_init_caches_and_decode_from_the_reference_caches():
    """zamba2: ``init_caches`` equals the reference's (Mamba and KV caches
    stacked per unit); a decode step from the reference's prefill caches
    handed over with ``caches_from_jax`` equals the reference's step."""
    jcfg, tcfg, jp, tp = _model("zamba2-7b")
    jz = jax.tree.map(np.asarray, jmodels.init_caches(B, 24, jcfg))
    tz = tmodels.init_caches(B, 24, tcfg, device="cpu")
    _assert_caches(tz, jz, tol=dict(rtol=0, atol=0))
    assert type(tz["units"]["p0"]).__name__ == "MambaCache"
    assert tz["units"]["p5"].k.shape[:3] == (tcfg.resolved_units, B, 24)
    batch = _batch(jcfg, 53)
    jl, jc = jmodels.forward_prefill(jp, _j(batch), jcfg, cache_len=S + 8)
    tc = tmodels.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    step = {"token": np.asarray(jnp.argmax(jl, -1), np.int32), "pos": np.full((B,), S, np.int32)}
    jl2, jt2, _ = jmodels.forward_decode(jp, _j(step), jc, jcfg)
    tl2, tt2, _ = tmodels.forward_decode(tp, _t(step), tc, tcfg)
    np.testing.assert_allclose(_np(tl2), _np(jl2), **TOL)
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))
    # each shared_attn occurrence has its own cache, all read the one block
    assert not torch.equal(tc["units"]["p5"].k[0], tc["units"]["p5"].k[1])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "llama4-scout-17b-16e",
                                  "llama4-maverick-400b-a17b", "mamba2-2.7b"])
def test_init_caches_of_the_other_families_match_the_reference(arch):
    jcfg, tcfg = _configs(arch)
    _assert_caches(tmodels.init_caches(B, 80, tcfg, device="cpu"),
                   jax.tree.map(np.asarray, jmodels.init_caches(B, 80, jcfg)),
                   tol=dict(rtol=0, atol=0))


@pytest.mark.parametrize("arch,seq", [(a, s) for a in FAMILIES for s in (S, S + 5)])
def test_prefill_decode_consistency(arch, seq):
    """The port's own: decoding after a prefill of ``seq`` tokens matches a
    one-longer prefill's last logits at the reference's bar."""
    _, tcfg, _, tp = _model(arch)
    toks = torch.from_numpy(_batch(_configs(arch)[0], 54, seq=seq + 1)["tokens"])
    full, _ = tmodels.forward_prefill(tp, {"tokens": toks}, tcfg)
    _, caches = tmodels.forward_prefill(tp, {"tokens": toks[:, :seq]}, tcfg, cache_len=seq + 8)
    step = {"token": toks[:, seq], "pos": torch.full((B,), seq, dtype=torch.int32)}
    gap = float((tmodels.forward_decode(tp, step, caches, tcfg)[0] - full).abs().max())
    assert gap < CONSISTENCY_TOL, gap


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,seq", [(a, s) for a in FAMILIES for s in (S, S + 5)])
def test_forward_prefill_and_decode(arch, seq):
    """Seed 34: the prefill of ``seq`` tokens (2 chunks of 16, and 2 chunks
    and 5 on the pad path), then four greedy steps, each package on its own
    tokens (equal at every step) and its own caches: Mamba caches (conv
    tail, f32 state) and, for zamba2, one KV cache per shared_attn
    occurrence."""
    jcfg, tcfg, jp, tp = _model(arch)
    batch = _batch(jcfg, 34, seq=seq)
    jl, jc = jmodels.forward_prefill(jp, _j(batch), jcfg, cache_len=seq + 8)
    tl, tc = tmodels.forward_prefill(tp, _t(batch), tcfg, cache_len=seq + 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    assert tl.shape == (B, tcfg.vocab_size)
    _assert_caches(tc, jax.tree.map(np.asarray, jc))
    jt, tt = jnp.argmax(jl, -1).astype(jnp.int32), torch.argmax(tl, -1).to(torch.int32)
    for i in range(4):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((B,), seq + i, np.int32)
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


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_lm_runs_reduced(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "lm", "--arch", arch, "--device", "cpu", "--reduced", "--retrieval",
                "--batch", "2", "--prompt-len", "16", "--gen-len", "3"])
    out = capsys.readouterr().out
    assert "[lm] prefill B=2 S=16" in out and "[lm] generated 3 tokens x 2 seqs" in out


@pytest.mark.parametrize("arch", FAMILIES)
def test_launch_train_runs_reduced(arch, tmp_path, capsys):
    from repro_torch.launch import train

    losses = train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps", "3",
                         "--seq-len", "32", "--global-batch", "2", "--ckpt-dir",
                         str(tmp_path / "ck")])
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert f"[train] arch={arch} reduced=True steps=3" in capsys.readouterr().out
