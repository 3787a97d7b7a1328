"""Port parity of the dense LM stack (CPU): layers, MLPs, attention, and
prefill/decode over whole models.

Inputs come from numpy with the seed each case states; parameters are the
reference's ``init_params`` handed over through ``params_from_jax`` (torch
cannot replay ``jax.random``), caches through ``caches_from_jax``. Bars
(f32, the reduced configs): layer outputs and logits rtol = atol = 1e-4, KV
caches 1e-5, greedy tokens equal; the bf16 case at the reference's own
consistency bar, 2e-2. The reference's ring-buffer behaviour past a full
window (decode after a prefill of S tokens, S > window, S % window != 0)
is pinned at S=40 with window 32: the port equals the reference there, and
both miss the one-longer prefill by the same gap.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import mlp as tmlp

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
DENSE = ["gemma3-1b", "gemma-2b", "qwen3-8b", "glm4-9b"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32) if not isinstance(x, torch.Tensor) else (
        x.float().numpy())


def _configs(arch, **overrides):
    j = dataclasses.replace(jconfigs.reduced_model(jconfigs.get_bundle(arch).model), **overrides)
    t = dataclasses.replace(tconfigs.reduced_model(tconfigs.get_bundle(arch).model), **overrides)
    return j, t


_MODELS = {}


def _model(arch, **overrides):
    """(reference cfg, port cfg, reference params, port params), the port's
    handed over from the reference's PRNGKey(0) draw."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg, tcfg = _configs(arch, **overrides)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tp = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _MODELS[key] = (jcfg, tcfg, jp, tp)
    return _MODELS[key]


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _assert_caches(tc, jc, tol=CACHE_TOL):
    assert set(tc) == set(jc)
    for group in jc:
        assert set(tc[group]) == set(jc[group])
        for p, jkv in jc[group].items():
            tkv = tc[group][p]
            np.testing.assert_allclose(_np(tkv.k), _np(jkv.k), **tol)
            np.testing.assert_allclose(_np(tkv.v), _np(jkv.v), **tol)
            np.testing.assert_array_equal(tkv.k_pos.numpy(), np.asarray(jkv.k_pos))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_matches_the_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in jconfigs.list_archs():
        jb, tb = jconfigs.get_bundle(arch), tconfigs.get_bundle(arch)
        assert dataclasses.asdict(tb) == dataclasses.asdict(jb), arch
        assert dataclasses.asdict(tconfigs.reduced_model(tb.model)) == dataclasses.asdict(
            jconfigs.reduced_model(jb.model)), arch
    assert dataclasses.asdict(tconfigs.RetrievalConfig()) == dataclasses.asdict(
        jconfigs.RetrievalConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_bundle("nope")
    # the registry sits beside the service configuration
    from repro_torch.configs.paper_alsh import SERVICE

    assert SERVICE.index_config.d == 128


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_tree_matches_the_reference(arch):
    _, tcfg, jp, _ = _model(arch)
    jp = jax.tree.map(np.asarray, jp)
    tp = tmodels.init_params(3, tcfg, device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = jax.tree_util.tree_flatten_with_path(tp)[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [jax.tree_util.keystr(p)
                                                           for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32, path
        if "scale" in jax.tree_util.keystr(path):
            assert not b.any()  # the (1 + scale) norms start at zero
        else:  # truncated normals: |x| <= 2 std, std near the reference's
            assert float(b.abs().max()) <= 2.0 * float(np.abs(a).max()) / 1.9 + 1e-6
            assert 0.7 < float(b.std()) / float(a.std()) < 1.4, path


def test_params_from_jax_names_a_bad_leaf():
    jcfg, tcfg, jp, _ = _model("gemma3-1b")
    tree = jax.tree.map(np.asarray, jp)
    tree["ln_f"]["scale"] = np.zeros((3,), np.float32)
    with pytest.raises(ValueError, match="params/ln_f/scale"):
        tmodels.params_from_jax(tree, tcfg, device="cpu")
    del tree["ln_f"]
    with pytest.raises(ValueError, match="keys"):
        tmodels.params_from_jax(tree, tcfg, device="cpu")


def test_init_fills_the_stacked_leaves_with_the_per_unit_draws():
    """``init_params`` fills the stacked unit leaves slice by slice; from the
    same seed it is bit for bit the tree a list of per-unit draws stacked
    afterwards gives (the order: embedding, lm_head, unit by unit and leaf
    by leaf, the tail, ln_f)."""
    from repro_torch.models import model as tmodel

    _, tcfg = _configs("gemma3-1b")
    got = tmodels.init_params(0, tcfg, device="cpu")
    gen, dtype = torch.Generator(device="cpu").manual_seed(0), torch.float32
    want = {"embed": tlayers.init_embed(gen, tcfg.vocab_size, tcfg.d_model, dtype)}
    if not tcfg.tie_embeddings:
        want["lm_head"] = tlayers.init_linear(gen, tcfg.d_model, tcfg.vocab_size, dtype, std=0.02)
    units = [{f"p{i}": tmodel._init_block(gen, kind, tcfg, dtype)
              for i, kind in enumerate(tcfg.scan_unit)} for _ in range(tcfg.resolved_units)]
    want["units"] = jax.tree.map(lambda *ts: torch.stack(ts), *units)
    want["tail"] = {f"p{i}": tmodel._init_block(gen, kind, tcfg, dtype)
                    for i, kind in enumerate(tcfg.tail)}
    want["ln_f"] = tlayers.init_rmsnorm(tcfg.d_model, dtype)
    jflat, tflat = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (want, got))
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    for (path, a), (_, b) in zip(jflat, tflat):
        assert torch.equal(a, b), jax.tree_util.keystr(path)
    assert bool(want["units"]["p0"]["attn"]["wq"]["w"].any())


# ---------------------------------------------------------------------------
# layers and MLPs
# ---------------------------------------------------------------------------


def test_rmsnorm_rope_mrope_softcap():
    rs = np.random.default_rng(11)
    x = rs.normal(size=(2, 7, 4, 16)).astype(np.float32)
    scale = rs.normal(size=(16,)).astype(np.float32) * 0.1
    np.testing.assert_allclose(
        tlayers.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-6).numpy(),
        np.asarray(jlayers.rmsnorm({"scale": scale}, jnp.asarray(x), 1e-6)), **TOL)
    pos = rs.integers(0, 200, (2, 7)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        np.testing.assert_allclose(
            tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)), **TOL)
    pos3 = rs.integers(0, 64, (3, 2, 7)).astype(np.int32)
    np.testing.assert_allclose(
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, (2, 3, 3)).numpy(),
        np.asarray(jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6, (2, 3, 3))),
        **TOL)
    with pytest.raises(ValueError, match="sum to head_dim/2"):
        tlayers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3), 1e6, (2, 3, 4))
    y = rs.normal(size=(3, 50)).astype(np.float32) * 40
    np.testing.assert_allclose(tlayers.softcap(torch.from_numpy(y), 30.0).numpy(),
                               np.asarray(jlayers.softcap(jnp.asarray(y), 30.0)), **TOL)
    assert tlayers.softcap(torch.from_numpy(y), None) is not None


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp(activation):
    p = jmlp.init_mlp(jax.random.PRNGKey(5), 32, 48, activation, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(12).normal(size=(2, 5, 32)).astype(np.float32)
    np.testing.assert_allclose(tmlp.mlp(tp, torch.from_numpy(x), activation).numpy(),
                               np.asarray(jmlp.mlp(p, jnp.asarray(x), activation)), **TOL)


def test_embed_unembed_in_bf16_keep_f32_sums():
    """bf16 operands, f32 result: the port's upcast product equals XLA's
    ``preferred_element_type=float32`` (exact products, f32 sums)."""
    rs = np.random.default_rng(13)
    table = rs.normal(size=(64, 32)).astype(np.float32)
    toks = rs.integers(0, 64, (2, 3)).astype(np.int32)
    x_j = jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jnp.bfloat16)
    x_t = tlayers.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks),
                        torch.bfloat16)
    np.testing.assert_array_equal(_np(x_t), np.asarray(x_j, np.float32))
    lj = jlayers.unembed({"table": jnp.asarray(table)}, x_j)
    lt = tlayers.unembed({"table": torch.from_numpy(table)}, x_t)
    assert lt.dtype == torch.float32
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _attn_inputs(tcfg, jcfg, S, seed):
    p = jattn.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    x = np.random.default_rng(seed).normal(size=(2, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    return p, tp, x, pos


@pytest.mark.parametrize("kind,S,blk_q,blk_kv", [
    ("attn", 32, 8, 16), ("global", 32, 8, 16), ("global_nope", 32, 8, 16),
    ("local", 40, 8, 8), ("chunked", 32, 8, 16),
    ("local", 48, 8, 16),  # S > window + blk_q: _sdpa_windowed
    ("chunked", 80, 8, 16),  # S > chunk + blk_q: _sdpa_windowed
    ("local", 30, 8, 16),  # padded queries (k_pos = -1)
])
def test_attn_sequence(kind, S, blk_q, blk_kv):
    jcfg, tcfg = _configs("gemma3-1b")
    p, tp, x, pos = _attn_inputs(tcfg, jcfg, S, seed=S + blk_q)
    want = jattn.attn_sequence(p, jnp.asarray(x), jnp.asarray(pos), jcfg, kind, blk_q, blk_kv)
    got = tattn.attn_sequence(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg, kind,
                              blk_q, blk_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("kind", ["global", "local"])
def test_attn_sequence_where_the_reference_reshape_raises(kind):
    """Padded length 24 is no multiple of blk_kv 16: the reference raises;
    the port pads the keys with k_pos = -1 and equals the reference's
    one-block answer."""
    jcfg, tcfg = _configs("gemma3-1b")
    p, tp, x, pos = _attn_inputs(tcfg, jcfg, 20, seed=7)
    with pytest.raises(TypeError, match="reshape"):
        jattn.attn_sequence(p, jnp.asarray(x), jnp.asarray(pos), jcfg, kind, 8, 16)
    want = jattn.attn_sequence(p, jnp.asarray(x), jnp.asarray(pos), jcfg, kind)
    got = tattn.attn_sequence(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg, kind, 8, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [32, 40])
def test_prefill_kv_and_decode_against_the_ring_buffer(S):
    """Local layer, window 32, cache of S + 8 slots (so 32): at S=40 the
    reference's first decode step overwrites slot 8, position 16, which is
    inside the window. The port does the same, to the bit of the caches."""
    jcfg, tcfg = _configs("gemma3-1b")
    p, tp, x, pos = _attn_inputs(tcfg, jcfg, S + 1, seed=S)
    clen = jattn.cache_len_for("local", jcfg, S + 8)
    assert clen == tattn.cache_len_for("local", tcfg, S + 8) == 32
    jc = jattn.prefill_kv(p, jnp.asarray(x[:, :S]), jnp.asarray(pos[:, :S]), jcfg, "local", clen)
    tc = tattn.prefill_kv(tp, torch.from_numpy(x[:, :S]), torch.from_numpy(pos[:, :S]), tcfg,
                          "local", clen)
    _assert_caches({"l": {"c": tc}}, {"l": {"c": jc}})
    step = np.full((2,), S, np.int32)
    jo, jc2 = jattn.attn_decode(p, jnp.asarray(x[:, S:]), jnp.asarray(step), jc, jcfg, "local")
    to, tc2 = tattn.attn_decode(tp, torch.from_numpy(x[:, S:]), torch.from_numpy(step), tc,
                                tcfg, "local")
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _assert_caches({"l": {"c": tc2}}, {"l": {"c": jc2}})
    assert int(tc.k_pos[0, S % 32]) == {32: 0, 40: 16}[S]  # the given cache is unchanged
    # against the one-longer sequence: equal at S=32, off by the same gap at S=40
    full = tattn.attn_sequence(tp, torch.from_numpy(x), torch.from_numpy(pos), tcfg, "local")
    gap = float((to[:, 0] - full[:, S]).abs().max())
    jfull = jattn.attn_sequence(p, jnp.asarray(x), jnp.asarray(pos), jcfg, "local")
    jgap = float(np.abs(np.asarray(jo)[:, 0] - np.asarray(jfull)[:, S]).max())
    assert abs(gap - jgap) < 1e-4
    if S == 32:
        assert gap < 1e-4
    else:
        assert gap > 1e-2, gap


def test_gqa_reads_kv_head_h_over_g():
    """qwen3 reduced: 4 heads over 2 kv heads. Zeroing kv head 1's values
    changes heads 2 and 3 only (head h reads kv head h // G)."""
    jcfg, tcfg = _configs("qwen3-8b")
    p, tp, x, pos = _attn_inputs(tcfg, jcfg, 8, seed=3)
    q, k, v = tattn._qkv(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos), "attn")
    out = tattn._sdpa_blocked(q, k, v, torch.from_numpy(pos), torch.from_numpy(pos), tcfg,
                              "attn", 8, 8)
    v2 = v.clone()
    v2[:, :, 1] = 0
    out2 = tattn._sdpa_blocked(q, k, v2, torch.from_numpy(pos), torch.from_numpy(pos), tcfg,
                               "attn", 8, 8)
    assert torch.equal(out[:, :, :2], out2[:, :, :2])
    assert not torch.allclose(out[:, :, 2:], out2[:, :, 2:])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _prefill_both(arch, S, seed, **overrides):
    jcfg, tcfg, jp, tp = _model(arch, **overrides)
    B = 2
    toks = _tokens(seed, (B, S), tcfg.vocab_size)
    jl, jc = jmodels.forward_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                     cache_len=S + 8)
    tl, tc = tmodels.forward_prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                                     cache_len=S + 8)
    return jcfg, tcfg, jp, tp, (jl, jc), (tl, tc)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_decode(arch):
    """Seed 21: prefill 40 tokens, then three greedy steps, each package on
    its own tokens (equal at every step) and its own caches."""
    jcfg, tcfg, jp, tp, (jl, jc), (tl, tc) = _prefill_both(arch, 40, seed=21)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches(tc, jax.tree.map(np.asarray, jc))
    jt = jnp.argmax(jl, -1).astype(jnp.int32)
    tt = torch.argmax(tl, -1).to(torch.int32)
    for i in range(3):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        pos = np.full((2,), 40 + i, np.int32)
        jl, jt, jc, jh = jmodels.forward_decode(jp, {"token": jt, "pos": jnp.asarray(pos)}, jc,
                                                jcfg, return_hidden=True)
        tl, tt, tc, th = tmodels.forward_decode(tp, {"token": tt, "pos": torch.from_numpy(pos)},
                                                tc, tcfg, return_hidden=True)
        assert tt.dtype == torch.int32 and th.shape == (2, tcfg.d_model)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
        _assert_caches(tc, jax.tree.map(np.asarray, jc))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_decode_from_the_reference_caches():
    """A decode step started from the reference's prefill caches (handed over
    with ``caches_from_jax``) equals the reference's step."""
    jcfg, tcfg, jp, tp, (jl, jc), _ = _prefill_both("gemma3-1b", 40, seed=22)
    tc = tmodels.caches_from_jax(jax.tree.map(np.asarray, jc), tcfg, device="cpu")
    step = {"token": np.asarray(jnp.argmax(jl, -1), np.int32), "pos": np.full((2,), 40, np.int32)}
    jl2, jt2, _ = jmodels.forward_decode(jp, {k: jnp.asarray(v) for k, v in step.items()}, jc,
                                         jcfg)
    tl2, tt2, _ = tmodels.forward_decode(tp, {k: torch.from_numpy(v) for k, v in step.items()},
                                         tc, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2))


def test_bf16_compute_at_the_reference_bar():
    """gemma3 reduced with compute_dtype bfloat16 (f32 params, as the full
    config): prefill and one decode step within rtol = atol = 2e-2."""
    jcfg, tcfg, jp, tp, (jl, jc), (tl, tc) = _prefill_both(
        "gemma3-1b", 32, seed=23, compute_dtype="bfloat16")
    assert tl.dtype == torch.float32 and tc["units"]["p0"].k.dtype == torch.bfloat16
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16_TOL)
    tok = _tokens(24, (2,), tcfg.vocab_size)
    pos = np.full((2,), 32, np.int32)
    jl2, _, _ = jmodels.forward_decode(jp, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
                                       jc, jcfg)
    tl2, _, _ = tmodels.forward_decode(tp, {"token": torch.from_numpy(tok),
                                            "pos": torch.from_numpy(pos)}, tc, tcfg)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **BF16_TOL)


def _consistency_gap(params, cfg, S, seed, prefill, decode, to, B=2):
    toks = _tokens(seed, (B, S + 1), cfg.vocab_size)
    full, _ = prefill(params, {"tokens": to(toks)}, cfg)
    _, caches = prefill(params, {"tokens": to(toks[:, :S])}, cfg, cache_len=S + 8)
    step = {"token": to(toks[:, S]), "pos": to(np.full((B,), S, np.int32))}
    logits = decode(params, step, caches, cfg)[0]
    return float(np.abs(np.asarray(logits) - np.asarray(full)).max())


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """The port's own: decoding after a prefill of S=32 (the reference's S)
    matches a one-longer prefill's last logits at the reference's bar."""
    _, tcfg, _, tp = _model(arch)
    gap = _consistency_gap(tp, tcfg, 32, 42, tmodels.forward_prefill, tmodels.forward_decode,
                           torch.from_numpy)
    assert gap < 2e-2, gap


def test_ring_buffer_gap_is_the_reference_gap():
    """S=40 past window 32 (seed 43): the consistency gap the reference has
    (ROADMAP.md Queue C item 2) is the port's too (the two packages' logits
    at S=40 agree at the f32 bar: ``test_forward_prefill_and_decode``)."""
    jcfg, tcfg, jp, tp = _model("gemma3-1b")
    tgap = _consistency_gap(tp, tcfg, 40, 43, tmodels.forward_prefill, tmodels.forward_decode,
                            torch.from_numpy)
    jgap = _consistency_gap(jp, jcfg, 40, 43, jmodels.forward_prefill, jmodels.forward_decode,
                            jnp.asarray)
    assert tgap > 1e-2 and abs(tgap - jgap) < 1e-4, (tgap, jgap)


def test_init_caches_match_the_reference():
    jcfg, tcfg = _configs("gemma3-1b")
    jc = jax.tree.map(np.asarray, jmodels.init_caches(2, 48, jcfg))
    tc = tmodels.init_caches(2, 48, tcfg, device="cpu")
    _assert_caches(tc, jc, tol=dict(rtol=0, atol=0))
    assert tc["units"]["p0"].k.shape == (2, 2, 32, 1, 16)  # local: min(window, S)
    assert tc["units"]["p5"].k.shape == (2, 2, 48, 1, 16)  # global: S
