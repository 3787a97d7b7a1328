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
mesh impls (``ep_shardmap``, ``a2a_shardmap``): with no mesh each equals the
reference's (gspmd's answer, 1e-5); one rank's bodies equal the
reference's (1e-5); under a (2, 4) CPU mesh without drops both are within
the reference's own bar of gspmd (2e-4), gradients included; and a2a with
drops equals an oracle that runs the reference's shard_map body rank by
rank (1e-5), since the reference's own mesh tests fail under jax 0.9.0
(ROADMAP.md Queue C item 2).
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
from repro_torch.models import sharding as tsh
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


# ---------------------------------------------------------------------------
# the mesh impls (ep_shardmap, a2a_shardmap)
# ---------------------------------------------------------------------------

MESH_BAR = 2e-4  # the reference's bar for ep_shardmap against gspmd (tests/test_distributed.py)
MESH_B, MESH_S = 8, 16


@pytest.fixture
def cpu_mesh():
    """A (2, 4) ("data", "model") mesh of the CPU; the policy reset after."""
    from repro_torch.launch.mesh import make_local_mesh

    yield make_local_mesh(2, 4, devices=[torch.device("cpu")] * 8)
    tsh.set_policy()


def _mesh_layer(capacity=None, seed=51, B=MESH_B, S=MESH_S):
    """The reduced scout's MoE layer (4 experts, one an EP rank of 4) and a
    (B, S, dm) input."""
    jcfg, tcfg = _configs("llama4-scout-17b-16e", capacity)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg, jcfg.moe, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(seed).normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


@pytest.mark.parametrize("impl", ["ep_shardmap", "a2a_shardmap"])
@pytest.mark.parametrize("capacity", [None, 0.5])
def test_mesh_impls_without_a_mesh_are_the_reference_s(impl, capacity):
    """No mesh active: both packages' impls answer as gspmd (seed 52)."""
    jcfg, tcfg, jp, tp, x = _mesh_layer(capacity, 52)
    jcfg, tcfg = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
    want = getattr(jmoe, f"moe_ffn_{impl}")(jp, jnp.asarray(x), jcfg, jcfg.moe)
    got = getattr(tmoe, f"moe_ffn_{impl}")(tp, torch.from_numpy(x), tcfg, tcfg.moe)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    np.testing.assert_array_equal(_np(tmoe.moe_ffn(tp, torch.from_numpy(x), tcfg, tcfg.moe)),
                                  _np(got))


@pytest.mark.parametrize("offset", [0, 1, 3])
def test_dispatch_bodies_match_the_reference(offset):
    """One EP rank's bodies (seed 53, 64 tokens, capacity 5 so tokens drop):
    ``_dispatch_compute_combine`` at ``E_offset`` over its local experts and
    ``_dispatch_by_ids`` over ids with -1 padding."""
    jcfg, tcfg, jp, tp, x = _mesh_layer(None, 53, B=4)
    rs = np.random.default_rng(53 + offset)
    xf = x.reshape(-1, jcfg.d_model)
    logits = (xf @ np.asarray(jp["router"]["w"])).astype(np.float32)
    E_local, C = 1, 5
    jwe = {k: v[offset:offset + E_local] for k, v in jp["experts"].items()}
    twe = {k: v[offset:offset + E_local] for k, v in tp["experts"].items()}
    want = jmoe._dispatch_compute_combine(jnp.asarray(xf), jnp.asarray(logits), jwe, E_local, C,
                                          E_offset=offset)
    got = tmoe._dispatch_compute_combine(torch.from_numpy(xf), torch.from_numpy(logits), twe,
                                         E_local, C, E_offset=offset)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    mine = int((np.argmax(logits, -1) == offset).sum())
    assert mine > C and int((_np(got) != 0).any(-1).sum()) == C  # dropped past C
    E2 = 2
    jwe2 = {k: v[:E2] for k, v in jp["experts"].items()}
    twe2 = {k: v[:E2] for k, v in tp["experts"].items()}
    ids = rs.integers(-1, E2, size=xf.shape[0]).astype(np.int32)
    want = jmoe._dispatch_by_ids(jnp.asarray(xf), jnp.asarray(ids), jwe2, E2, C + 10)
    got = tmoe._dispatch_by_ids(torch.from_numpy(xf), torch.from_numpy(ids).long(), twe2, E2,
                                C + 10)
    np.testing.assert_allclose(_np(got), _np(want), **MOE_TOL)
    assert not _np(got)[ids < 0].any()


def _grads(fn, tp, x):
    """fn's output and the grads of its sum over x and every parameter leaf."""
    leaves = tts.tree_leaves(tp)
    live = [t.clone().requires_grad_() for t in leaves]
    it = iter(live)
    params = tts.tree_map(lambda _: next(it), tp)
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(params, xt)
    return out.detach(), torch.autograd.grad(out.sum(), [xt, *live])


@pytest.mark.parametrize("dp_over_model", [False, True])
@pytest.mark.parametrize("impl", ["ep_shardmap", "a2a_shardmap"])
def test_mesh_impls_under_a_cpu_mesh_match_gspmd(cpu_mesh, impl, dp_over_model):
    """Under a (2, 4) CPU mesh at the reduced capacity factor (>= T: nothing
    drops), megatron layout (tokens replicated over EP; a2a hands over to
    ep_shardmap) and dp_over_model (tokens split over data x model): the
    output and every gradient within the reference's bar of gspmd's, all
    finite (seed 54)."""
    jcfg, tcfg, jp, tp, x = _mesh_layer(None, 54)
    want, wgrads = _grads(lambda p, xt: tmoe.moe_ffn_gspmd(p, xt, tcfg, tcfg.moe), tp, x)
    tsh.set_policy(dp_over_model=dp_over_model)
    with tsh.use_mesh(cpu_mesh):
        got, grads = _grads(
            lambda p, xt: getattr(tmoe, f"moe_ffn_{impl}")(p, xt, tcfg, tcfg.moe), tp, x)
    np.testing.assert_allclose(_np(got), _np(want), rtol=MESH_BAR, atol=MESH_BAR)
    for g, w in zip(grads, wgrads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(_np(g), _np(w), rtol=MESH_BAR, atol=MESH_BAR)


def _a2a_oracle(jp, x, jcfg, n_data=2, ep=4):
    """The reference's a2a ``shard_map`` body, run per rank with its own jnp
    ops under dp_over_model on an (n_data, ep) mesh: each rank's pack (its
    scatter-add and scatter-set), the all_to_all as a transpose of the send
    buffers, ``jmoe._dispatch_by_ids`` per receiving rank, the transpose
    back and the unpack; then the shared expert. Also how many tokens each
    stage dropped."""
    B, S, dm = x.shape
    E, cf = jcfg.moe.n_experts, jcfg.moe.capacity_factor
    E_local, Bl = E // ep, B // (n_data * ep)
    T_l = Bl * S
    Cp = max(8, int(cf * T_l / ep) + 1)
    C2 = max(8, int(cf * ep * Cp / E_local) + 1)
    blocks = x.reshape(n_data, ep, T_l, dm)
    out = np.zeros_like(blocks)
    dropped = [0, 0]
    for d in range(n_data):
        packs = []
        for r in range(ep):
            xf = jnp.asarray(blocks[d, r])
            logits = (xf @ jp["router"]["w"]).astype(jnp.float32)
            eg = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            gate = jax.nn.sigmoid(jnp.max(logits, axis=-1))
            target = eg // E_local
            sidx = jnp.argsort(target)
            st = target[sidx]
            counts = jnp.sum(jax.nn.one_hot(target, ep, dtype=jnp.int32), axis=0)
            offs = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]])
            pos = jnp.arange(T_l, dtype=jnp.int32) - offs[st]
            keep = pos < Cp
            safe = jnp.where(keep, pos, Cp - 1)
            sbuf = jnp.zeros((ep, Cp, dm)).at[st, safe].add(xf[sidx] * keep[:, None])
            smeta = jnp.full((ep, Cp), -1, jnp.int32).at[st, safe].set(
                jnp.where(keep, eg[sidx] % E_local, -1))
            dropped[0] += int((~keep).sum())
            packs.append((sbuf, smeta, st, safe, keep, sidx, gate))
        ys = []
        for dst in range(ep):
            rbuf = jnp.stack([packs[src][0][dst] for src in range(ep)]).reshape(ep * Cp, dm)
            rmeta = jnp.stack([packs[src][1][dst] for src in range(ep)]).reshape(ep * Cp)
            we = {k: v[dst * E_local:(dst + 1) * E_local] for k, v in jp["experts"].items()}
            ids = np.asarray(rmeta)
            per = np.bincount(ids[ids >= 0], minlength=E_local)
            dropped[1] += int(np.maximum(per - C2, 0).sum())
            ys.append(jmoe._dispatch_by_ids(rbuf, rmeta, we, E_local, C2).reshape(ep, Cp, dm))
        for src in range(ep):
            _, _, st, safe, keep, sidx, gate = packs[src]
            ybuf = jnp.stack([ys[dst][src] for dst in range(ep)])
            back = ybuf[st, safe] * keep[:, None]
            out[d, src] = np.asarray(back[jnp.argsort(sidx)] * gate[:, None])
    shared = jmodels.model.mlp.mlp(jp["shared"], jnp.asarray(x.reshape(B * S, dm)), "swiglu")
    return out.reshape(B, S, dm) + np.asarray(shared).reshape(B, S, dm), dropped


def test_a2a_with_drops_matches_the_per_rank_oracle(cpu_mesh):
    """Capacity factor 0.5 under dp_over_model on the (2, 4) CPU mesh (seed
    55, 8 x 64 tokens): tokens drop at the send (Cp) and at the receiving
    experts (C2), and the port's answer is the oracle's."""
    jcfg, tcfg, jp, tp, x = _mesh_layer(0.5, 55, S=64)
    want, dropped = _a2a_oracle(jp, x, jcfg)
    assert dropped[0] > 0 and dropped[1] > 0, dropped
    tsh.set_policy(dp_over_model=True)
    with tsh.use_mesh(cpu_mesh):
        got = tmoe.moe_ffn_a2a_shardmap(tp, torch.from_numpy(x), tcfg, tcfg.moe)
    np.testing.assert_allclose(_np(got), want, **MOE_TOL)


@pytest.mark.parametrize("impl", ["ep_shardmap", "a2a_shardmap"])
def test_forward_train_under_each_impl_without_a_mesh(impl):
    """The reduced scout's loss with ``moe_impl`` set and no mesh (seed 56):
    the reference's, and gspmd's."""
    jcfg, tcfg, jp, tp = _model("llama4-scout-17b-16e")
    jcfg, tcfg2 = (dataclasses.replace(c, moe_impl=impl) for c in (jcfg, tcfg))
    batch = _batch(jcfg, 56)
    want = jax.jit(lambda p, b: jmodels.forward_train(p, b, jcfg))(jp, _j(batch))
    got = tmodels.forward_train(tp, _t(batch), tcfg2)
    assert abs(float(got) - float(want)) <= F32_LOSS_TOL * abs(float(want))
    assert float(got) == float(tmodels.forward_train(tp, _t(batch), tcfg))



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
