"""Port parity of training (CPU): the synthetic stream, ``forward_train``
with its gradients, remat and the chunked loss, every ``optim`` function,
and ``make_train_step``.

Inputs come from numpy with the seed each case states; model parameters
are the reference's ``init_params`` handed over with ``params_from_jax``,
training states with ``train_state_from_jax`` (torch cannot replay
``jax.random``). Each reference variant is jitted once per module.

Bars, stated once here:
  * the stream: byte for byte;
  * f32 compute: loss within ``F32_LOSS_TOL`` (relative), every gradient
    leaf within ``F32_GRAD_TOL`` of its largest |entry| — the same
    operations summed in other orders;
  * bf16 compute: the two packages round bf16 intermediates at other points
    (XLA keeps some in f32), so the loss is held within ``BF16_LOSS_TOL``
    and the gradients by relative L2 error over the whole tree: no farther
    from the reference's bf16 gradients than ``BF16_NOISE`` times the
    distance between the reference's own bf16 and f32 gradients (what bf16
    rounding moves them by), and each leaf within ``BF16_LEAF_L2``;
  * remat on, off and "dots": the port bit-equal to itself; the chunked
    loss against the unchunked within ``F32_LOSS_TOL`` (another summation
    order), bit-equal to itself across remat modes;
  * ``optim``: lr bit-equal, the rest within ``OPTIM_TOL`` (f32 rounding
    over a few steps; a bf16 moment within one bf16 rounding); int8 codes
    equal;
  * ``make_train_step`` (f32 compute), after each of three steps: loss and
    grad norm within ``STEP_METRIC_RTOL``, lr within ``LR_ULPS`` f32 ulps
    of the jitted reference's (XLA contracts the schedule's multiply-adds
    and turns its divisions by constants into products with reciprocals;
    the schedule alone, as written, is bit-equal); parameters within
    ``STEP_PARAM_LR`` of the learning rates summed so far (Adam's
    g / sqrt(v) turns the last-bit differences of a gradient entry near 0
    into a visible part of one step); each moment leaf within
    ``STEP_MOMENT_TOL`` of its largest |entry| (f32 rounding; a bf16
    rounding for bf16 moments); each error-feedback leaf within
    ``STEP_EF_TOL`` of its largest |entry| (the gradients' f32 differences
    are ~250 times smaller relative to the residual, which spans half an
    int8 quantum). int8 compression is not continuous: where an int8 code
    rounds the other way in one package, its entry moves by a whole quantum
    in the residual and the sum, and by up to a step's lr in the parameter.
    So with ``int8_ef`` at most ``STEP_INT8_FLIPS`` of a leaf's entries (and
    at least one) may be past its bar; elsewhere none may.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.optim as joptim
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticStream as JStream
from repro.runtime import train_step as jts
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.optim as toptim
from repro_torch.data import DataConfig, SyntheticStream
from repro_torch.runtime import train_step as tts

F32_LOSS_TOL = 1e-6
F32_GRAD_TOL = 2e-5
BF16_LOSS_TOL = 2e-3
BF16_NOISE = 1.5
BF16_LEAF_L2 = 0.1
OPTIM_TOL = dict(rtol=1e-6, atol=1e-7)
BF16_MOMENT_TOL = dict(rtol=2 ** -7, atol=1e-7)
STEP_METRIC_RTOL = 1e-5
LR_ULPS = 2
STEP_PARAM_LR = 0.05
STEP_MOMENT_TOL = {"float32": 1e-4, "bfloat16": 2 ** -7}
STEP_EF_TOL = 0.01
STEP_INT8_FLIPS = 0.01
B, S = 2, 64


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


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _flat(tree) -> dict:
    """{leaf name: float64 numpy} of either package's tree."""
    out = {}
    for name, leaf in tts.named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            out[name] = leaf.detach().double().numpy()
        else:
            out[name] = np.asarray(leaf, dtype=np.float64)
    return out


_PARAMS = {}


def _params(arch, **overrides):
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _PARAMS:
        jcfg, tcfg = _configs(arch, **overrides)
        jp = jmodels.init_params(jax.random.PRNGKey(0), jcfg)
        tp = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
        _PARAMS[key] = (jcfg, tcfg, jp, tp)
    return _PARAMS[key]


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma3-1b", "hubert-xlarge", "qwen2-vl-2b"])
def test_synthetic_stream_matches_the_reference(arch):
    """LM, audio and vision batches: the same bytes across steps and shards."""
    jcfg, tcfg = _configs(arch)
    for n_shards, shard in ((1, 0), (2, 0), (2, 1)):
        kw = dict(seq_len=24, global_batch=4, seed=7, n_shards=n_shards, shard_id=shard)
        ref, port = JStream(JDataConfig(**kw), jcfg), SyntheticStream(DataConfig(**kw), tcfg)
        for step in (0, 1, 5, 1000):
            a, b = ref.batch(step), port.batch(step)
            assert list(a) == list(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (k, step)
                assert a[k].tobytes() == b[k].tobytes(), (arch, k, step, n_shards, shard)
    assert port.batch(3)["tokens" if "tokens" in b else "targets"].tobytes() != \
        port.batch(4)["tokens" if "tokens" in b else "targets"].tobytes()
    with pytest.raises(ValueError, match="does not split"):
        SyntheticStream(DataConfig(seq_len=8, global_batch=3, n_shards=2), tcfg)


# ---------------------------------------------------------------------------
# forward_train and its gradients
# ---------------------------------------------------------------------------

VARIANTS = {
    "gemma3-1b f32": ("gemma3-1b", {}),
    "gemma3-1b bf16 remat": ("gemma3-1b", {"compute_dtype": "bfloat16", "remat": True}),
    "qwen3-8b f32": ("qwen3-8b", {}),
    "qwen3-8b bf16": ("qwen3-8b", {"compute_dtype": "bfloat16"}),
    "qwen3-8b f32 loss_chunk dots": ("qwen3-8b", {"loss_chunk": 16, "remat": True,
                                                   "remat_policy": "dots"}),
}
_REF = {}


def _reference(variant):
    """The reference's jitted (loss, grads as {name: float64}) of one
    variant on seed-11 tokens, computed once per module."""
    if variant not in _REF:
        arch, overrides = VARIANTS[variant]
        jcfg, _, jp, _ = _params(arch, **overrides)
        toks = _tokens(11, (B, S), jcfg.vocab_size)
        fn = jax.jit(jax.value_and_grad(lambda p, t: jmodels.forward_train(p, {"tokens": t},
                                                                           jcfg)))
        loss, grads = fn(jp, jnp.asarray(toks))
        _REF[variant] = (float(loss), _flat(jax.tree.map(np.asarray, grads)))
    return _REF[variant]


def _rel_l2(got, want):
    return np.sqrt(sum(np.sum((got[k] - want[k]) ** 2) for k in want)
                   / sum(np.sum(want[k] ** 2) for k in want))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_train_loss_and_grads_match_the_reference(variant):
    arch, overrides = VARIANTS[variant]
    jcfg, tcfg, jp, tp = _params(arch, **overrides)
    jloss, want = _reference(variant)
    toks = _tokens(11, (B, S), jcfg.vocab_size)
    loss, grads = tts._value_and_grad(tp, {"tokens": torch.as_tensor(toks)}, tcfg)
    assert loss.dtype == torch.float32 and loss.ndim == 0
    got = _flat(grads)
    assert list(want) == list(got)
    for (name, g), (_, p) in zip(tts.named_leaves(grads), tts.named_leaves(tp)):
        assert g.dtype == p.dtype and g.shape == p.shape, name
    if jcfg.compute_dtype == "float32":
        assert abs(float(loss) - jloss) <= F32_LOSS_TOL * abs(jloss)
        for name in want:
            scale = np.max(np.abs(want[name]))
            err = np.max(np.abs(got[name] - want[name]))
            assert err <= F32_GRAD_TOL * scale, (name, err, scale)
    else:
        assert abs(float(loss) - jloss) <= BF16_LOSS_TOL
        noise = _rel_l2(want, _reference(f"{arch} f32")[1])
        assert _rel_l2(got, want) <= BF16_NOISE * noise, (_rel_l2(got, want), noise)
        for name in want:
            rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(want[name])
            assert rel <= BF16_LEAF_L2, (name, rel)


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_remat_and_loss_chunk_change_no_bit(compute):
    """remat off, on ("nothing") and "dots" give the same loss and gradients
    bit for bit; the chunked loss equals the unchunked within F32_LOSS_TOL
    and is itself bit-equal across the remat modes."""
    _, base, _, tp = _params("gemma3-1b")
    toks = {"tokens": torch.as_tensor(_tokens(12, (B, S), base.vocab_size))}
    runs = {}
    for chunk in (0, 16):
        for remat, policy in ((False, "nothing"), (True, "nothing"), (True, "dots")):
            cfg = dataclasses.replace(base, compute_dtype=compute, remat=remat,
                                      remat_policy=policy, loss_chunk=chunk)
            runs[chunk, remat, policy] = tts._value_and_grad(tp, toks, cfg)
    for chunk in (0, 16):
        loss0, g0 = runs[chunk, False, "nothing"]
        for key in ((chunk, True, "nothing"), (chunk, True, "dots")):
            loss, g = runs[key]
            assert torch.equal(loss, loss0), key
            for (name, a), (_, b) in zip(tts.named_leaves(g0), tts.named_leaves(g)):
                assert torch.equal(a, b), (key, name)
    whole, chunked = runs[0, False, "nothing"][0], runs[16, False, "nothing"][0]
    assert abs(float(whole) - float(chunked)) <= F32_LOSS_TOL * abs(float(whole))


def test_remat_recomputes_in_the_backward_pass():
    """The backward pass replays the forward's weight products (``aten.mm``)
    with remat "nothing", not with "dots" (it keeps them) nor without remat;
    "dots" still replays the other ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.mm = self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.mm += func is torch.ops.aten.mm.default
            return func(*args, **(kwargs or {}))

    _, base, _, tp = _params("gemma3-1b")
    toks = {"tokens": torch.as_tensor(_tokens(13, (B, S), base.vocab_size))}

    def backward_ops(cfg):
        live = tts.tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss = tmodels.forward_train(live, toks, cfg)
        with Count() as count:
            torch.autograd.grad(loss, tts.tree_leaves(live))
        return count

    plain = backward_ops(base)
    nothing = backward_ops(dataclasses.replace(base, remat=True))
    dots = backward_ops(dataclasses.replace(base, remat=True, remat_policy="dots"))
    # each unit's 6 layers x 7 products (q, k, v, o, up, gate, down) replayed,
    # but for its last one, whose output no backward op needs (the
    # recomputation stops once it has what the backward asked for)
    assert nothing.mm == plain.mm + base.resolved_units * (6 * 7 - 1), (nothing.mm, plain.mm)
    assert dots.mm == plain.mm and dots.ops > plain.ops, (dots.mm, dots.ops, plain.ops)


def test_forward_train_refuses_unported_families_and_specs():
    for arch in ("llama4-scout-17b-16e", "mamba2-2.7b", "hubert-xlarge"):
        cfg = tconfigs.reduced_model(tconfigs.get_bundle(arch).model)
        with pytest.raises(NotImplementedError, match="Queue A item 14c"):
            tmodels.forward_train({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)}, cfg)
    mcfg = tconfigs.reduced_model(tconfigs.get_bundle("gemma3-1b").model)
    trc = tconfigs.TrainConfig()
    for call in (lambda: tts.train_state_specs(mcfg, trc), lambda: tts.batch_pytree_specs({}),
                 lambda: tts.jit_train_step(mcfg, trc, {}),
                 lambda: toptim.adamw.opt_state_specs({}, trc)):
        with pytest.raises(NotImplementedError, match="Queue A item 14d"):
            call()


# ---------------------------------------------------------------------------
# optim
# ---------------------------------------------------------------------------


def _tree(rs, scale=1.0):
    return {"b": rs.normal(size=(16,)).astype(np.float32) * scale,
            "blk": {"w": rs.normal(size=(8, 16)).astype(np.float32) * scale,
                    "x": rs.normal(size=(4, 4, 4)).astype(np.float32) * scale}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tts.tree_map(lambda a: torch.as_tensor(np.array(a)), tree)


def _close(port, ref, tol=OPTIM_TOL):
    a, b = _flat(ref), _flat(port)
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **tol)


def test_lr_schedule_is_the_references_bit_for_bit():
    tcfg = tconfigs.TrainConfig(warmup_steps=7, total_steps=40, learning_rate=3e-4)
    for s in (0, 1, 3, 7, 8, 20, 39, 40, 41, 1000):
        want = np.asarray(joptim.lr_schedule(jnp.asarray(s, jnp.int32), tcfg))
        got = toptim.lr_schedule(torch.tensor(s, dtype=torch.int32), tcfg)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert got.numpy().tobytes() == want.astype(np.float32).tobytes(), s


def test_clip_by_global_norm_matches_the_reference():
    rs = np.random.default_rng(21)
    for scale, max_norm in ((0.01, 1.0), (10.0, 1.0), (3.0, 0.5)):
        g = _tree(rs, scale)
        jg, jn = joptim.clip_by_global_norm(_to_jax(g), max_norm)
        tg, tn = toptim.clip_by_global_norm(_to_torch(g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _close(tg, jax.tree.map(np.asarray, jg))


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference_over_steps(opt_dtype):
    """Five steps from the same parameters and gradients; moments stored in
    ``opt_dtype``; lr and step bit-equal, the rest within OPTIM_TOL (a bf16
    moment within one bf16 rounding of the reference's)."""
    rs = np.random.default_rng(22)
    tcfg = tconfigs.TrainConfig(warmup_steps=2, total_steps=10, optimizer_dtype=opt_dtype,
                                weight_decay=0.1, grad_clip=1.0)
    p = _tree(rs)
    jp, tp = _to_jax(p), _to_torch(p)
    js, tstate = joptim.init_opt_state(jp, tcfg), toptim.init_opt_state(tp, tcfg)
    tol = OPTIM_TOL if opt_dtype == "float32" else BF16_MOMENT_TOL
    for step in range(5):
        g = _tree(rs, scale=0.5 if step % 2 else 3.0)  # clipped every other step
        jp, js, jm = joptim.adamw_update(jp, _to_jax(g), js, tcfg)
        tp, tstate, tm = toptim.adamw_update(tp, _to_torch(g), tstate, tcfg)
        assert int(tstate.step) == int(js.step) == step + 1
        assert tstate.step.dtype == torch.int32 and tstate.step.ndim == 0
        assert tm["lr"].numpy().tobytes() == np.asarray(jm["lr"]).tobytes()
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        _close(tp, jax.tree.map(np.asarray, jp))
        _close({"m": tstate.m, "v": tstate.v},
               {"m": jax.tree.map(np.asarray, js.m), "v": jax.tree.map(np.asarray, js.v)}, tol)
        for leaf in tts.tree_leaves(tstate.m) + tts.tree_leaves(tstate.v):
            assert leaf.dtype == getattr(torch, opt_dtype)
        for leaf in tts.tree_leaves(tp):
            assert leaf.dtype == torch.float32 and not leaf.requires_grad


@pytest.mark.parametrize("mode", [None, "bf16", "int8_ef"])
def test_compression_matches_the_reference_over_rounds(mode):
    """Three rounds of compress → accumulate with the error feedback
    carried: int8 codes and bf16 casts equal, scales, residuals and sums
    within OPTIM_TOL."""
    rs = np.random.default_rng(23)
    shapes = _tree(rs)
    jef = tef = None
    if mode == "int8_ef":
        jef = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), _to_jax(shapes))
        tef = _to_torch(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
    jacc = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32), _to_jax(shapes))
    tacc = _to_torch(jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes))
    for _ in range(3):
        g = _tree(rs, scale=2.0)
        jc, jef = joptim.compress_grads(_to_jax(g), mode, jef)
        tc, tef = toptim.compress_grads(_to_torch(g), mode, tef)
        if mode == "int8_ef":
            jpairs = jax.tree.leaves(jc, is_leaf=lambda x: isinstance(x, tuple))
            tpairs = tts.tree_leaves(tc)
            for (jq, js), (tq, ts) in zip(jpairs, tpairs):
                assert tq.dtype == torch.int8 and ts.dtype == torch.float32 and ts.ndim == 0
                np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
                np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
            _close(tef, jax.tree.map(np.asarray, jef))
        elif mode == "bf16":
            for jl, tl in zip(jax.tree.leaves(jc), tts.tree_leaves(tc)):
                assert tl.dtype == torch.bfloat16
                np.testing.assert_array_equal(tl.float().numpy(), np.asarray(jl, np.float32))
        jacc = joptim.decompress_accumulate(jacc, jc, mode)
        tacc = toptim.decompress_accumulate(tacc, tc, mode)
        _close(tacc, jax.tree.map(np.asarray, jacc))
    with pytest.raises(ValueError):
        toptim.compress_grads(_to_torch(shapes), "fp4")


# ---------------------------------------------------------------------------
# make_train_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("microbatch,mode,opt_dtype", [(1, None, "bfloat16"),
                                                      (2, "int8_ef", "float32")])
def test_make_train_step_matches_the_reference(microbatch, mode, opt_dtype):
    """Three steps of the reference's jitted step and the port's from the
    same state (handed over) on the same batches (reduced qwen3-8b)."""
    base, tbase = _configs("qwen3-8b")
    trc = dataclasses.replace(jconfigs.get_bundle("qwen3-8b").train, warmup_steps=2,
                              total_steps=10, microbatch=microbatch, grad_compression=mode,
                              optimizer_dtype=opt_dtype)
    ttrc = tconfigs.TrainConfig(**dataclasses.asdict(trc))
    jstate = jts.init_train_state(jax.random.PRNGKey(3), base, trc)
    tstate = tmodels.train_state_from_jax(jax.tree.map(np.asarray, jstate), tbase, ttrc,
                                          device="cpu")
    assert ("opt/ef/embed/table" in tts.train_state_leaves(tstate)) == (mode == "int8_ef")
    jstep = jax.jit(jts.make_train_step(base, trc))
    tstep = tts.make_train_step(tbase, ttrc)
    moment_tol = STEP_MOMENT_TOL[opt_dtype]
    flips = STEP_INT8_FLIPS if mode == "int8_ef" else 0
    lr_sum = 0.0
    for i in range(3):
        toks = _tokens(30 + i, (4, 32), base.vocab_size)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        before = {k: v.clone() for k, v in tts.train_state_leaves(tstate).items()}
        new, tm = tstep(tstate, {"tokens": torch.as_tensor(toks)})
        for k, v in tts.train_state_leaves(tstate).items():  # the old state is left as it was
            assert torch.equal(v, before[k]), k
        tstate = new
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=STEP_METRIC_RTOL,
                                       err_msg=k)
        np.testing.assert_array_max_ulp(tm["lr"].numpy(), np.asarray(jm["lr"]), maxulp=LR_ULPS)
        lr_sum += float(jm["lr"])
        want, got = _flat(jax.tree.map(np.asarray, jstate)), _flat(tstate)
        assert list(want) == list(got)
        assert got["opt/step"] == want["opt/step"] == i + 1
        for k in want:
            if k.startswith("params/"):
                bar = STEP_PARAM_LR * lr_sum
            else:
                tol = STEP_EF_TOL if k.startswith("opt/ef/") else moment_tol
                bar = tol * np.max(np.abs(want[k]))
            off = int(np.sum(np.abs(got[k] - want[k]) > bar))
            allowed = max(1, int(flips * want[k].size)) if flips else 0
            assert off <= allowed, f"step {i}: {k}: {off} of {want[k].size} entries past {bar}"
        for leaf in tts.tree_leaves(tstate.params):
            assert not leaf.requires_grad and leaf.grad_fn is None


def test_token_nll_backward_is_autograds_bit_for_bit():
    """The CE's hand-written backward (one (…, V) buffer in place) gives
    the gradient autograd derives from logsumexp and gather, bit for bit."""
    from repro_torch.models.model import _TokenNLL

    rs = np.random.default_rng(14)
    x = torch.tensor(rs.normal(size=(2, 5, 37)).astype(np.float32) * 4, requires_grad=True)
    idx = torch.tensor(rs.integers(0, 37, (2, 5, 1)))
    g = torch.tensor(rs.normal(size=(2, 5)).astype(np.float32))
    want = torch.autograd.grad(
        torch.sum((torch.logsumexp(x, -1) - torch.gather(x, -1, idx)[..., 0]) * g), x)[0]
    nll = _TokenNLL.apply(x, idx)
    assert torch.equal(nll, torch.logsumexp(x, -1) - torch.gather(x, -1, idx)[..., 0])
    got = torch.autograd.grad(torch.sum(nll * g), x)[0]
    assert torch.equal(got, want)
