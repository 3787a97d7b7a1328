"""Port parity of the ALSH retrieval attachment (CPU): the cases of
``tests/test_retrieval.py`` with its ``RCFG``, on a datastore the
reference builds and hands over (``retrieval_state_from_jax``), plus a
growing datastore and the serve CLI's ``--mode lm``.

The lookups are handed the same reduced keys (the reference's
``reduce_key``): hidden states that differ in the 7th digit between the
packages could move a key across a level boundary. Bars: kNN ids equal,
dists within rtol/atol 1e-5 (tests/test_kernels_topk.py), kNN log-probs and
the interpolation within atol 1e-5. The decode step with retrieval runs the
whole path from the hidden state, on seed 31, with tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
from repro.api import planner as jplanner
from repro.runtime import retrieval as jrt
from repro.runtime.serve_step import make_decode_step as jmake_decode_step
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.api import Planner
from repro_torch.api import planner as tplanner
from repro_torch.runtime import retrieval as trt
from repro_torch.runtime.serve_step import make_decode_step as tmake_decode_step

RCFG = dict(datastore_size=2048, d_key=16, M=16, K=6, L=8, max_candidates=32, topk=4,
            interp_lambda=0.3)
DIST = dict(rtol=1e-5, atol=1e-5)
LOGP = dict(rtol=0, atol=1e-5)


def _rcfgs(**overrides):
    kw = dict(RCFG, **overrides)
    return jconfigs.RetrievalConfig(**kw), tconfigs.RetrievalConfig(**kw)


def _arrays(jstate):
    """The reference state's leaves as ``retrieval_state_from_jax`` takes them."""
    idx = jstate.index
    s = idx.state
    out = {
        "folded": np.asarray(s.tables.folded), "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers), "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm), "data": np.asarray(s.data), "levels": np.asarray(s.levels),
        "scales": None if s.scales is None else np.asarray(s.scales),
        "values": np.asarray(jstate.values), "proj": np.asarray(jstate.proj),
        "default_w": np.asarray(jstate.default_w),
    }
    if idx.mutable:
        out.update(delta_data=np.asarray(idx.delta.data),
                   delta_levels=np.asarray(idx.delta.levels),
                   delta_keys=np.asarray(idx.delta.keys), delta_fill=np.asarray(idx.delta.fill),
                   tombstones=np.asarray(idx.tombstones))
    return out


def _pair(key, d_model=64, vocab=512, **overrides):
    jr, tr = _rcfgs(**overrides)
    jstate = jrt.build_datastore(key, d_model, vocab, jr)
    tstate = trt.retrieval_state_from_jax(_arrays(jstate), tr, device="cpu")
    return jr, tr, jstate, tstate


def _hidden(seed, b, d_model):
    return np.random.default_rng(seed).normal(size=(b, d_model)).astype(np.float32)


def _same_lookup(tstate, jstate, q, w, tspec, jspec):
    t = tstate.index.query(torch.from_numpy(q), torch.from_numpy(w), tspec)
    j = jstate.index.query(jnp.asarray(q), jnp.asarray(w), jspec)
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_allclose(t.dists.numpy(), np.asarray(j.dists), **DIST)
    np.testing.assert_array_equal(t.n_candidates.numpy(), np.asarray(j.n_candidates))


def _same_knn(tstate, tr, jstate, jr, hidden, vocab, weights=None):
    """Both packages' kNN log-probs from the reference's reduced keys."""
    q = np.array(jrt.reduce_key(jnp.asarray(hidden), jstate))
    want = jrt.retrieve_logits(jnp.asarray(hidden), jstate, jr, vocab,
                               weights=None if weights is None else jnp.asarray(weights))
    got = trt.knn_logprobs(torch.from_numpy(q), tstate, tr, vocab,
                           weights=None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGP)
    # and the port's own key reduction agrees to f32 rounding
    np.testing.assert_allclose(trt.reduce_key(torch.from_numpy(hidden), tstate).numpy(), q,
                               rtol=1e-6, atol=1e-6)
    return got


def test_handover_keeps_the_state(rng):
    jr, tr, jstate, tstate = _pair(rng)
    assert tstate.index.n == jstate.index.n == 2048 and not tstate.index.mutable
    assert tstate.values.dtype == torch.int32 and tstate.values.shape == (2048,)
    np.testing.assert_array_equal(tstate.proj.numpy(), np.asarray(jstate.proj))
    assert tstate.index.config == trt.index_config(tr)
    assert trt.query_spec(tr) == trt.QuerySpec(k=4)


def test_datastore_build_and_probe(rng):
    jr, tr, jstate, tstate = _pair(rng)
    hidden = _hidden(1, 4, 64)
    q = np.array(jrt.reduce_key(jnp.asarray(hidden), jstate))
    w = np.broadcast_to(np.asarray(jstate.default_w), q.shape).copy()
    _same_lookup(tstate, jstate, q, w, trt.query_spec(tr), jrt.query_spec(jr))
    logp = _same_knn(tstate, tr, jstate, jr, hidden, 512)
    assert logp.shape == (4, 512)
    np.testing.assert_allclose(logp.exp().sum(-1).numpy(), 1.0, atol=1e-3)


def test_port_built_datastore_probes():
    """The port's own build (torch draws): a log-prob distribution, the same
    on every call and the same datastore from the same seed."""
    tr = tconfigs.RetrievalConfig(**RCFG)
    a = trt.build_datastore(0, 64, 512, tr, device="cpu")
    b = trt.build_datastore(0, 64, 512, tr, device="cpu")
    assert torch.equal(a.index.state.sorted_keys, b.index.state.sorted_keys)
    assert torch.equal(a.values, b.values) and a.values.max() < 512
    np.testing.assert_allclose(a.default_w.numpy(), 1.0 / (
        a.index.state.data.numpy().std(axis=0) + 1e-3), rtol=1e-5)
    hidden = torch.from_numpy(_hidden(2, 4, 64))
    logp = trt.retrieve_logits(hidden, a, tr, 512)
    assert torch.equal(logp, trt.retrieve_logits(hidden, b, tr, 512))
    np.testing.assert_allclose(logp.exp().sum(-1).numpy(), 1.0, atol=1e-3)


def test_quality_first_datastore(rng, monkeypatch):
    """``recall_target`` plans the lookup: the reference at build, the port on
    the handed-over index through the same call (the reference's calibration
    samples handed over). Equal plans, the memo hit at decode, and the
    planned lookup equal to the reference's."""
    samples = []
    orig = jplanner.Planner._sample

    def record(planner, key, data, m, jitter):
        qs, ws = orig(planner, key, data, m, jitter)
        samples.append((np.asarray(qs), np.asarray(ws)))
        return qs, ws

    def hand(planner, generator, data, m, jitter):
        qs, ws = samples.pop(0)
        return torch.from_numpy(qs), torch.from_numpy(ws)

    monkeypatch.setattr(jplanner.Planner, "_sample", record)
    monkeypatch.setattr(tplanner.Planner, "_sample", hand)
    jr, tr, jstate, tstate = _pair(rng, recall_target=0.7)
    tspec, jspec = trt.query_spec(tr), jrt.query_spec(jr)
    assert jspec in jstate.index.plans and tspec not in tstate.index.plans
    planned = tstate.index.plan(tspec, planner=Planner(weights=tstate.default_w))
    want = jstate.index.plans[jspec]
    assert not samples
    for f in dataclasses.fields(planned):
        if f.name != "predicted_success":
            assert getattr(planned, f.name) == getattr(want, f.name), f.name
    np.testing.assert_allclose(planned.predicted_success, want.predicted_success, rtol=1e-6)
    hidden = _hidden(7, 4, 64)
    got = _same_knn(tstate, tr, jstate, jr, hidden, 512)  # through the memo
    q = trt.reduce_key(torch.from_numpy(hidden), tstate)
    w = tstate.default_w.expand(q.shape)
    res = tstate.index.query(q, w, planned)
    direct = tstate.index.query(q, w, tspec)
    assert torch.equal(res.ids, direct.ids) and torch.equal(res.dists, direct.dists)
    assert got.shape == (4, 512)


def test_port_quality_first_build_plans_eagerly():
    tr = tconfigs.RetrievalConfig(**dict(RCFG, recall_target=0.7))
    state = trt.build_datastore(3, 64, 512, tr, device="cpu")
    spec = trt.query_spec(tr)
    assert spec in state.index.plans
    hidden = torch.from_numpy(_hidden(8, 4, 64))
    q = trt.reduce_key(hidden, state)
    a = trt.retrieve_logits(hidden, state, tr, 512)
    res = state.index.query(q, state.default_w.expand(q.shape), state.index.plans[spec])
    assert a.shape == (4, 512) and bool((res.ids >= 0).any())


def test_interpolation_is_valid_distribution(rng):
    jr, tr, jstate, tstate = _pair(rng)
    hidden = _hidden(2, 2, 64)
    lm_logits = np.random.default_rng(3).normal(size=(2, 512)).astype(np.float32)
    knn = _same_knn(tstate, tr, jstate, jr, hidden, 512)
    want = jrt.interpolate(jnp.asarray(lm_logits), jnp.asarray(knn.numpy()), jr.interp_lambda)
    mixed = trt.interpolate(torch.from_numpy(lm_logits), knn, tr.interp_lambda)
    np.testing.assert_allclose(mixed.numpy(), np.asarray(want), **LOGP)
    np.testing.assert_allclose(mixed.exp().sum(-1).numpy(), 1.0, atol=1e-3)


def test_decode_step_with_retrieval(rng):
    """Seed 31: reduced gemma3 with handed-over parameters and datastore,
    two steps of the retrieval decode from zero caches in both packages —
    mixed log-probs within 1e-4, tokens equal — and retrieval moves the
    distribution off the plain decode's."""
    jcfg = jconfigs.reduced_model(jconfigs.get_bundle("gemma3-1b").model)
    tcfg = tconfigs.reduced_model(tconfigs.get_bundle("gemma3-1b").model)
    jp = jmodels.init_params(rng, jcfg)
    tp = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jr, tr, jstate, tstate = _pair(jax.random.fold_in(rng, 1), jcfg.d_model, jcfg.vocab_size)
    jc = jmodels.init_caches(2, 32, jcfg)
    tc = tmodels.init_caches(2, 32, tcfg, device="cpu")
    jstep, tstep = jmake_decode_step(jcfg, jr), tmake_decode_step(tcfg, tr)
    tok = np.random.default_rng(31).integers(0, 512, (2,)).astype(np.int32)
    jt, tt = jnp.asarray(tok), torch.from_numpy(tok)
    for i in range(2):
        pos = np.full((2,), i, np.int32)
        jl, jt, jc = jstep(jp, {"token": jt, "pos": jnp.asarray(pos)}, jc, jstate)
        tl, tt, tc = tstep(tp, {"token": tt, "pos": torch.from_numpy(pos)}, tc, tstate)
        assert tl.shape == (2, tcfg.vocab_size) and bool(torch.isfinite(tl).all())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    plain = tmake_decode_step(tcfg, None)
    batch = {"token": torch.zeros((2,), dtype=torch.int32), "pos": torch.zeros((2,),
                                                                            dtype=torch.int32)}
    caches = tmodels.init_caches(2, 32, tcfg, device="cpu")
    plogits, _, _ = plain(tp, batch, caches)
    mixed, _, _ = tstep(tp, batch, caches, tstate)
    assert not torch.allclose(torch.log_softmax(plogits, -1), mixed, atol=1e-4)


@pytest.mark.parametrize("retrieval", [False, True], ids=["plain", "retrieval"])
def test_decode_step_returns_hidden(rng, retrieval):
    """``return_hidden`` adds the final hidden state to the step's outputs
    and changes nothing else: the same logits, tokens and caches as the
    step without it, and the hidden state ``forward_decode`` returns."""
    tcfg = tconfigs.reduced_model(tconfigs.get_bundle("gemma3-1b").model)
    tp = tmodels.init_params(0, tcfg, device="cpu")
    tr = tconfigs.RetrievalConfig(**RCFG) if retrieval else None
    extra = (trt.build_datastore(0, tcfg.d_model, tcfg.vocab_size, tr, device="cpu"),) \
        if retrieval else ()
    caches = tmodels.init_caches(2, 32, tcfg, device="cpu")
    batch = {"token": torch.tensor([3, 7], dtype=torch.int32),
             "pos": torch.zeros((2,), dtype=torch.int32)}
    logits, tok, c = tmake_decode_step(tcfg, tr)(tp, batch, caches, *extra)
    logits_h, tok_h, c_h, hidden = tmake_decode_step(tcfg, tr, return_hidden=True)(
        tp, batch, caches, *extra)
    assert torch.equal(logits_h, logits) and torch.equal(tok_h, tok)
    for a, b in zip(jax.tree.leaves(c), jax.tree.leaves(c_h)):
        assert torch.equal(a, b)
    want = tmodels.forward_decode(tp, batch, caches, tcfg, return_hidden=True)[3]
    assert hidden.shape == (2, tcfg.d_model) and torch.equal(hidden, want)


@pytest.mark.parametrize("keys", ["sigmoid_normal", "uniform", "near_duplicate"])
def test_recall_matches_the_reference(rng, keys):
    """recall@k of the probe lookups against exact mode is the reference's
    on the same keys (seed 37): decode-step-like keys (a sigmoid of normal
    draws, bunched mid-range), keys drawn like the datastore's (uniform) and
    near-duplicates of its records (+ U(-0.01, 0.01)); both lookups' ids
    equal, so a low recall is the data's and the config's, not the port's."""
    from repro_torch.distance import recall_at_k

    jr, tr, jstate, tstate = _pair(rng)
    rs = np.random.default_rng(37)
    data = np.asarray(jstate.index.state.data)
    q = {"sigmoid_normal": 1.0 / (1.0 + np.exp(-rs.normal(size=(32, 16)))),
         "uniform": rs.random((32, 16)),
         "near_duplicate": np.clip(data[rs.integers(0, 2048, 32)]
                                   + rs.uniform(-0.01, 0.01, (32, 16)), 0.0, 1.0)}[keys]
    q = q.astype(np.float32)
    w = np.broadcast_to(np.asarray(jstate.default_w), q.shape).copy()
    exact_t, exact_j = trt.QuerySpec(k=4, mode="exact"), jrt.QuerySpec(k=4, mode="exact")
    _same_lookup(tstate, jstate, q, w, trt.query_spec(tr), jrt.query_spec(jr))
    _same_lookup(tstate, jstate, q, w, exact_t, exact_j)
    tq, tw = torch.from_numpy(q), torch.from_numpy(w)
    got = recall_at_k(tstate.index.query(tq, tw, trt.query_spec(tr)).ids,
                      tstate.index.query(tq, tw, exact_t).ids, 4)
    jq, jw = jnp.asarray(q), jnp.asarray(w)
    want = recall_at_k(np.asarray(jstate.index.query(jq, jw, jrt.query_spec(jr)).ids),
                       np.asarray(jstate.index.query(jq, jw, exact_j).ids), 4)
    assert got == want


def test_per_query_weights_change_retrieval(rng):
    """The paper's headline property end to end: the SAME hidden state with
    a different query-time weight vector retrieves differently — in both
    packages alike."""
    jr, tr, jstate, tstate = _pair(rng, d_model=32, vocab=128)
    hidden = _hidden(5, 1, 32)
    w1 = np.ones((1, 16), np.float32)
    w2 = np.concatenate([10 * np.ones((1, 8)), 0.01 * np.ones((1, 8))], 1).astype(np.float32)
    l1 = _same_knn(tstate, tr, jstate, jr, hidden, 128, weights=w1)
    l2 = _same_knn(tstate, tr, jstate, jr, hidden, 128, weights=w2)
    assert not torch.allclose(l1, l2)


def test_growing_datastore(rng):
    """delta_capacity 64 (seed 33 hidden states): extend twice — the second
    overflows the delta, its tail refused with -1 and no value written —,
    retire a main and a delta record, then look up; every step equal to the
    reference's, bucket keys and assigned ids included."""
    jr, tr, jstate, tstate = _pair(rng, delta_capacity=64)
    assert tstate.index.mutable and tstate.values.shape == (2048 + 64,)
    rs = np.random.default_rng(33)
    for m in (40, 40):
        hidden = rs.normal(size=(m, 64)).astype(np.float32)
        toks = rs.integers(0, 512, (m,)).astype(np.int32)
        jstate, jids = jrt.extend_datastore(jstate, jnp.asarray(hidden), jnp.asarray(toks))
        tstate, tids = trt.extend_datastore(tstate, torch.from_numpy(hidden),
                                            torch.from_numpy(toks))
        np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
        np.testing.assert_array_equal(tstate.values.numpy(), np.asarray(jstate.values))
        np.testing.assert_array_equal(tstate.index.delta.keys.numpy(),
                                      np.asarray(jstate.index.delta.keys))
    assert (tids.numpy() == -1).sum() == 16 and tstate.index.delta_fill == 64
    dead = np.array([5, 2048 + 3], np.int32)
    jstate = jrt.retire_datastore(jstate, jnp.asarray(dead))
    tstate = trt.retire_datastore(tstate, torch.from_numpy(dead))
    q = np.array(jrt.reduce_key(jnp.asarray(hidden[:16]), jstate))
    w = np.ones_like(q)
    for k in (1, 4):
        _same_lookup(tstate, jstate, q, w, trt.QuerySpec(k=k), jrt.QuerySpec(k=k))
    res = tstate.index.query(torch.from_numpy(q), torch.from_numpy(w), trt.QuerySpec(k=4))
    assert not torch.isin(res.ids, torch.from_numpy(dead)).any()
    _same_knn(tstate, tr, jstate, jr, hidden[:16], 512)


def test_serve_cli_lm_with_retrieval_on_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--mode", "lm", "--device", "cpu", "--reduced", "--retrieval", "--batch", "2",
                "--prompt-len", "16", "--gen-len", "4"])
    out = capsys.readouterr().out
    assert "[lm] prefill B=2 S=16 in" in out and "(retrieval=on)" in out
    assert "[lm] generated 4 tokens x 2 seqs in" in out and "sample: [" in out


def test_serve_cli_lm_needs_the_card_by_default(monkeypatch):
    from repro_torch.launch import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        serve.main(["--mode", "lm", "--reduced"])
