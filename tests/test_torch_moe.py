"""Port parity of the MoE families (CPU): llama4-scout-17b-16e (every layer
MoE) and llama4-maverick-400b-a17b (MoE on every other layer, the dense ones
at ``d_ff_dense``), and ``models.moe`` alone, against the JAX package at the
reduced sizes.

Inputs come from numpy with the seed each case states (batches from the
reference's ``SyntheticStream``); parameters are the reference's
``init_params`` (``init_moe``) handed over with ``params_from_jax``, caches
with ``caches_from_jax``, training states with ``train_state_from_jax``.
Bars (f32): ``moe_ffn_gspmd`` within rtol = atol = 1e-5 with and without
capacity drops; logits rtol = atol = 1e-4, caches 1e-5, greedy tokens equal;
the loss within 1e-6 relative and every gradient leaf within 2e-5 of its
largest |entry|; one ``make_train_step`` at ``tests/test_torch_train.py``'s
bars (metrics 1e-5, lr within 2 ulps, parameters within 0.05 of the lr,
moments within 1e-4 of a leaf's largest, or one bf16 rounding for bf16
moments) — but for an entry whose gradient is within ``ADAM_NEAR_EPS`` times
Adam's eps of 0: its first step, lr·g/(|g| + eps), turns the last bits of
such a gradient (1e-7 of its leaf's largest, within the gradient bar) into
any part of the lr. The reduced configs set the capacity factor to the
expert count, so nothing drops there; the drop cases set it to 0.5. The
reference's ``ep_shardmap``/``a2a_shardmap`` have no ground truth (their own
tests fail, ROADMAP.md Queue C item 2): the port refuses them, naming Queue
A item 14d.
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
from repro.models import moe as jmoe
from repro.runtime import train_step as jts
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.models import moe as tmoe
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
FAMILIES = ["llama4-scout-17b-16e", "llama4-maverick-400b-a17b"]
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
B, S = 2, 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, capacity=None, **overrides):
    """The reduced configs (capacity_factor = n_experts: nothing drops),
    or with ``capacity`` as the capacity factor."""
    out = []
    for pkg in (jconfigs, tconfigs):
        cfg = dataclasses.replace(pkg.reduced_model(pkg.get_bundle(arch).model), **overrides)
        if capacity is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                                   capacity_factor=capacity))
        out.append(cfg)
    return out


_MODELS = {}


def _model(arch, capacity=None):
    """(reference cfg, port cfg, reference params, port params), the port's
    handed over from the reference's PRNGKey(0) draw."""
    if (arch, capacity) not in _MODELS:
        jcfg, tcfg = _configs(arch, capacity)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tp = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[arch, capacity] = (jcfg, tcfg, jp, tp)
    return _MODELS[arch, capacity]


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
    # maverick's dense layers take d_ff_dense, its MoE layers d_ff_expert
    units = tmodels.init_params(3, tcfg, device="cpu")["units"]
    for i, kind in enumerate(tcfg.scan_unit):
        ffn = units[f"p{i}"]["ffn"]
        if kind.endswith("_moe"):
            assert ffn["experts"]["w_up"].shape[2:] == (tcfg.d_model, tcfg.moe.d_ff_expert)
        else:
            assert ffn["w_up"]["w"].shape[1:] == (tcfg.d_model, tcfg.moe.d_ff_dense)


# ---------------------------------------------------------------------------
# models.moe
# ---------------------------------------------------------------------------


def _moe_inputs(capacity, seed, T=64):
    """The reduced scout's MoE layer (reference ``init_moe``, handed over)
    and an (B, T/B, dm) input; how many tokens the capacity drops."""
    jcfg, tcfg = _configs("llama4-scout-17b-16e", capacity)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jcfg.moe, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(size=(B, T // B, jcfg.d_model)).astype(np.float32)
    logits = x.reshape(T, -1) @ np.asarray(jp["router"]["w"])
    counts = np.bincount(np.argmax(logits, -1), minlength=jcfg.moe.n_experts)
    C = jmoe._capacity(T, jcfg.moe.n_experts, jcfg.moe.capacity_factor)
    return jcfg, tcfg, jp, tp, x, int(np.maximum(counts - C, 0).sum())


@pytest.mark.parametrize("capacity,drops", [(None, False), (0.5, True)])
def test_moe_ffn_gspmd_matches_the_reference(capacity, drops):
    """Seed 41, 64 tokens over 4 experts: the reduced capacity factor (no
    drops) and 0.5 (C = 9 slots an expert: tokens past them are dropped)."""
    jcfg, tcfg, jp, tp, x, n_dropped = _moe_inputs(capacity, 41)
    assert (n_dropped > 0) == drops, n_dropped
    want = jmoe.moe_ffn_gspmd(jp, jnp.asarray(x), jcfg, jcfg.moe)
    got = tmoe.moe_ffn_gspmd(tp, torch.from_numpy(x), tcfg, tcfg.moe)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    np.testing.assert_array_equal(_np(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, tcfg.moe)),
                                  _np(got))


def test_moe_ffn_a_dropped_token_keeps_only_the_shared_expert():
    """At capacity factor 0.5 a dropped token's output is the shared
    expert's alone (its routed part is 0), as the reference's."""
    jcfg, tcfg, jp, tp, x, n_dropped = _moe_inputs(0.5, 42)
    assert n_dropped > 0
    got = tmoe.moe_ffn_gspmd(tp, torch.from_numpy(x), tcfg, tcfg.moe).reshape(-1, jcfg.d_model)
    shared = tmodels.model.mlp.mlp(tp["shared"], torch.from_numpy(x).reshape(got.shape),
                                   "swiglu")
    routed_zero = (got - shared).abs().amax(dim=-1) == 0
    assert int(routed_zero.sum()) == n_dropped


def test_moe_ffn_router_ties_go_to_the_lower_expert():
    """A zero router ties every token's logits: ``argmax`` picks expert 0 in
    both packages, which then overflows its capacity (seed 44)."""
    jcfg, tcfg, jp, tp, x, _ = _moe_inputs(0.5, 44)
    jp = dict(jp, router={"w": jnp.zeros_like(jp["router"]["w"])})
    tp = dict(tp, router={"w": torch.zeros_like(tp["router"]["w"])})
    want = jmoe.moe_ffn_gspmd(jp, jnp.asarray(x), jcfg, jcfg.moe)
    got = tmoe.moe_ffn_gspmd(tp, torch.from_numpy(x), tcfg, tcfg.moe)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    shared = tmodels.model.mlp.mlp(tp["shared"], torch.from_numpy(x), "swiglu")
    routed = (got - shared).abs().amax(dim=-1).reshape(-1)  # token order
    C = tmoe._capacity(x.shape[0] * x.shape[1], tcfg.moe.n_experts, 0.5)
    assert bool((routed[:C] > 0).all()) and not bool(routed[C:].any())


def test_aux_load_balance_loss_and_capacity():
    rs = np.random.default_rng(43)
    for E in (4, 16):
        logits = rs.normal(size=(96, E)).astype(np.float32) * 2
        np.testing.assert_allclose(
            float(tmoe.aux_load_balance_loss(torch.from_numpy(logits), E)),
            float(jmoe.aux_load_balance_loss(jnp.asarray(logits), E)), rtol=1e-6)
    for T, E, f in ((64, 4, 0.5), (64, 4, 4.0), (16, 16, 1.25), (4096, 128, 1.25), (3, 8, 1.0)):
        assert tmoe._capacity(T, E, f) == jmoe._capacity(T, E, f), (T, E, f)


@pytest.mark.parametrize("impl", ["ep_shardmap", "a2a_shardmap"])
def test_shardmap_impls_raise_naming_queue_a_item_14d(impl):
    """The mesh programs are refused, before any work, by every entry point
    and by ``moe_ffn`` itself; ``moe_ffn_gspmd`` stays callable."""
    _, tcfg = _configs("llama4-scout-17b-16e", moe_impl=impl)
    tp = _model("llama4-scout-17b-16e")[3]
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.int32)}
    x = torch.zeros((1, 4, tcfg.d_model))
    for call in (lambda: tmodels.init_params(0, tcfg, device="cpu"),
                 lambda: tmodels.forward_prefill(tp, toks, tcfg),
                 lambda: tmodels.forward_train(tp, toks, tcfg),
                 lambda: tmodels.init_caches(1, 8, tcfg, device="cpu"),
                 lambda: tmodels.params_from_jax({}, tcfg, device="cpu"),
                 lambda: tmoe.moe_ffn(tp["units"]["p0"]["ffn"], x, tcfg, tcfg.moe)):
        with pytest.raises(NotImplementedError,
                           match=f"moe_impl='{impl}'.*ROADMAP.md Queue A item 14d"):
            call()
    p0 = {k: v for k, v in tmodels.model._index(tp["units"], 0)["p0"]["ffn"].items()}
    assert tmoe.moe_ffn_gspmd(p0, x, tcfg, tcfg.moe).shape == x.shape


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,capacity", [(a, None) for a in FAMILIES]
                         + [("llama4-scout-17b-16e", 0.5)])
def test_forward_prefill_and_decode(arch, capacity):
    """Seed 34: the prefill, then four greedy steps, each package on its own
    tokens (equal at every step) and its own caches; scout also at capacity
    factor 0.5, where the prefill drops tokens."""
    jcfg, tcfg, jp, tp = _model(arch, capacity)
    batch = _batch(jcfg, 34)
    jl, jc = jmodels.forward_prefill(jp, _j(batch), jcfg, cache_len=S + 8)
    tl, tc = tmodels.forward_prefill(tp, _t(batch), tcfg, cache_len=S + 8)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
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


def _consistency_gap(params, cfg, seed, prefill, decode, to, seq=64):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, seq + 1)).astype(np.int32)
    full, _ = prefill(params, {"tokens": to(toks)}, cfg)
    _, caches = prefill(params, {"tokens": to(toks[:, :seq])}, cfg, cache_len=seq + 8)
    step = {"token": to(toks[:, seq]), "pos": to(np.full((1,), seq, np.int32))}
    return float(np.abs(_np(decode(params, step, caches, cfg)[0]) - _np(full)).max())


@pytest.mark.parametrize("capacity", [None, 1.25])
def test_capacity_drop_gap_is_the_reference_gap(capacity):
    """Seed 42, S=64: with nothing dropped (the reduced capacity factor) a
    decode step after a prefill matches a one-longer prefill at the
    reference's bar; at the full configs' factor 1.25 the two prefills drop
    other tokens, and the port misses by the reference's own gap."""
    jcfg, tcfg, jp, tp = _model("llama4-scout-17b-16e", capacity)
    tgap = _consistency_gap(tp, tcfg, 42, tmodels.forward_prefill, tmodels.forward_decode,
                            torch.from_numpy)
    jgap = _consistency_gap(jp, jcfg, 42, jmodels.forward_prefill, jmodels.forward_decode,
                            jnp.asarray)
    if capacity is None:
        assert tgap < 2e-2 and jgap < 2e-2, (tgap, jgap)
    else:
        assert tgap > 2e-2 and abs(tgap - jgap) < 1e-4, (tgap, jgap)


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
