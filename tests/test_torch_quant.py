"""Port parity of the quantized-storage slice and multiprobe (CPU).

The same numpy inputs, drawn from a seed, go through the JAX package and
``repro_torch``:

  * codecs and the screen helpers are bit-equal (``jnp.round`` and
    ``torch.round`` both round half to even; both cast to bf16 with
    round-to-nearest-even);
  * the plain quantized gather matches ``repro.kernels.ref`` and the Pallas
    blocked kernel in interpret mode: ids equal, dists within rtol/atol
    1e-5 (tests/test_kernels_topk.py's bar);
  * the engine on an index built by the JAX package and carried across
    returns equal ids, dists within 1e-5 and equal ``n_candidates`` for
    bf16/int8 × theta/l2 × probe/exact × α ∈ {0, 2} and theta multiprobe;
  * multiprobe keys are bit-equal in the exact-arithmetic fixture, where
    every projection and subset score is exact in f32 whatever the
    summation order (near-tied float scores could otherwise swap at the P
    boundary).

A JAX bf16 array converts to numpy as ``ml_dtypes.bfloat16``, which torch
cannot read; it is carried as its 16-bit pattern.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core.hash_families as jhf
import repro_torch.api as tapi
from repro import quant as jquant
from repro.core.multiprobe import multiprobe_keys_for as j_mp_keys
from repro.core.transforms import BoundedSpace as JSpace
from repro.kernels import ref as jref
from repro.kernels.gather_rerank import gather_rerank_topk_pallas_blocked
from repro_torch import quant as tquant
from repro_torch.core.multiprobe import multiprobe_keys_for as t_mp_keys
from repro_torch.core.transforms import BoundedSpace as TSpace
from repro_torch.kernels import ops as tops

N, D, M, K, L, C, B, TOPK = 2048, 16, 32, 8, 8, 32, 48, 10
TORCH_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}


def _bits(x):
    """The bit pattern of a JAX or torch array as numpy (exact comparison)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    if x.dtype == np.float32:
        return x.view(np.uint32)
    return x


def _to_torch(x):
    """A JAX or numpy array as a torch tensor of the same dtype and bits."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.tensor(x.view(np.int16)).view(torch.bfloat16)
    return torch.tensor(x)


def _rows(seed, n=64, d=D):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, d)).astype(np.float32) * rs.uniform(0.1, 3.0, (1, d)).astype(np.float32)
    x[:, 3] = 0.0  # an all-zero dimension gets scale 1.0
    return x


# ---------------------------------------------------------------------------
# codecs and the screen helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_codec_encode_decode_bit_equal(name, seed):
    x = _rows(seed)
    jp, js = jquant.get_codec(name).encode(jnp.asarray(x))
    tp, ts = tquant.get_codec(name).encode(torch.from_numpy(x))
    assert tp.dtype == TORCH_DTYPES[name]
    assert np.array_equal(_bits(tp), _bits(jp))
    assert (ts is None) == (js is None) == (name == "bf16")
    if name == "int8":
        assert np.array_equal(_bits(ts), _bits(js))
        assert np.array_equal(
            _bits(tquant.get_codec(name).fit_scales(torch.from_numpy(x))),
            _bits(jquant.get_codec(name).fit_scales(jnp.asarray(x))),
        )
        assert float(ts[3]) == 1.0
    assert np.array_equal(_bits(tquant.decode_table(tp, ts)), _bits(jquant.decode_table(jp, js)))


@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_codec_encode_rows_saturates_bit_equal(name):
    x = _rows(2)
    _, js = jquant.get_codec(name).encode(jnp.asarray(x))
    ts = None if js is None else _to_torch(js)
    wild = x * 10.0  # outside the fitted range: int8 saturates at ±127
    je = jquant.get_codec(name).encode_rows(jnp.asarray(wild), js)
    te = tquant.get_codec(name).encode_rows(torch.from_numpy(wild), ts)
    assert np.array_equal(_bits(te), _bits(je))
    if name == "int8":
        assert int(te.abs().max()) == 127


def test_round_half_to_even_in_both_frameworks():
    x = np.array([[0.5, 1.5, 2.5, -0.5, -1.5, 126.5]], np.float32)
    ones = np.ones((6,), np.float32)
    je = jquant.get_codec("int8").encode_rows(jnp.asarray(x), jnp.asarray(ones))
    te = tquant.get_codec("int8").encode_rows(torch.from_numpy(x), torch.from_numpy(ones))
    assert te.tolist() == [[0, 2, 2, 0, -2, 126]]
    assert np.array_equal(te.numpy(), np.asarray(je))


def test_codec_registry_matches_reference():
    for name in ("f32", "bf16", "int8"):
        assert tquant.bytes_per_value(name) == jquant.bytes_per_value(name)
        assert tquant.storage_dtype(name) == TORCH_DTYPES[name]
        assert tquant.get_codec(name).scaled == jquant.get_codec(name).scaled
    x = torch.from_numpy(_rows(3))
    payload, scales = tquant.get_codec("f32").encode(x)
    assert payload is x and scales is None  # a true passthrough
    assert tquant.decode_table(x, None) is x
    with pytest.raises(ValueError, match="storage codec"):
        tquant.get_codec("int4")
    with pytest.raises(ValueError, match="no registered storage codec"):
        tquant.decode_table(torch.zeros((2, 2), dtype=torch.float16), None)


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_proxy_query_bit_equal(name):
    rs = np.random.default_rng(4)
    x = _rows(4)
    q = (rs.normal(size=(9, D)) * 2).astype(np.float32)  # partly outside the fit: saturates
    w = rs.normal(size=(9, D)).astype(np.float32)
    jp, js = jquant.get_codec(name).encode(jnp.asarray(x))
    jq, jw = jquant.proxy_query(jnp.asarray(q), jnp.asarray(w), jp.dtype, js)
    ts = None if js is None else _to_torch(js)
    tq, tw = tquant.proxy_query(torch.from_numpy(q), torch.from_numpy(w), TORCH_DTYPES[name], ts)
    assert tq.dtype == tw.dtype == torch.float32
    assert np.array_equal(_bits(tq), _bits(jq))
    assert np.array_equal(_bits(tw), _bits(jw))


def test_screen_keep_matches_reference_on_a_grid():
    for k in (1, 3, 10, 64):
        for alpha in (0.0, 1.0, 1.5, 2.0, 3.7, 8.0):
            for n_slots in (1, 5, 20, 21, 40, 4096):
                assert tquant.screen_keep(k, alpha, n_slots) == jquant.screen_keep(
                    k, alpha, n_slots
                ), (k, alpha, n_slots)


# ---------------------------------------------------------------------------
# the plain quantized gather
# ---------------------------------------------------------------------------

# (n, b, P, d, k): d % 4 != 0; one 128-lane row block; k above the valid count
GATHER_SHAPES = [(40, 2, 24, 6, 5), (64, 3, 64, 128, 10), (10, 2, 16, 5, 20)]


@pytest.mark.parametrize("n,b,P,d,k", GATHER_SHAPES)
@pytest.mark.parametrize("case", ["bf16", "int8", "int8-proxy", "f32-scaled"])
def test_plain_quantized_gather_matches_reference(case, n, b, P, d, k):
    rs = np.random.default_rng(n + P + d + k)
    x = rs.uniform(-1, 1, (n, d)).astype(np.float32)
    q = rs.uniform(-1, 1, (b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)
    ids = np.minimum(rs.integers(0, n + n // 3, (b, P)), n).astype(np.int32)
    ids[0] = n  # a query with no valid candidate
    codec = "f32" if case == "f32-scaled" else case.split("-")[0]
    jp, js = jquant.get_codec(codec).encode(jnp.asarray(x))
    if case == "f32-scaled":
        js = jnp.asarray(rs.uniform(0.5, 2.0, (d,)).astype(np.float32))
    if case == "int8-proxy":  # the screen pass: integer levels, w·s, no scales
        jq, jw = jquant.proxy_query(jnp.asarray(q), jnp.asarray(w), jp.dtype, js)
        js = None
    else:
        jq, jw = jnp.asarray(q), jnp.asarray(w)
    want = jref.gather_rerank_topk(jp, jnp.asarray(ids), jq, jw, k, scales=js)
    pallas = gather_rerank_topk_pallas_blocked(jp, jnp.asarray(ids), jq, jw, k, scales=js,
                                               interpret=True)
    got = tops.gather_rerank_topk(
        _to_torch(jp), torch.from_numpy(ids), _to_torch(jq), _to_torch(jw), k,
        scales=None if js is None else _to_torch(js),
    )
    gd, gi = (t.numpy() for t in got)
    for wd, wi in (want, pallas):
        np.testing.assert_allclose(gd, np.asarray(wd), rtol=1e-5, atol=1e-5)
        assert np.array_equal(gi, np.asarray(wi))
    assert np.all(gi[0] == -1) and np.all(np.isinf(gd[0]))
    assert np.array_equal(gi == -1, ~np.isfinite(gd))


# ---------------------------------------------------------------------------
# the engine: an index built by the JAX package, queried by both
# ---------------------------------------------------------------------------


def _round(x, bits):
    return (np.round(np.asarray(x, np.float64) * 2.0**bits) / 2.0**bits).astype(np.float32)


def _inputs(seed, exact=False):
    rs = np.random.default_rng(seed)
    data = rs.uniform(0, 1, (N, D)).astype(np.float32)
    q = rs.uniform(0, 1, (B, D)).astype(np.float32)
    w = rs.normal(size=(B, D)).astype(np.float32)  # mixed signs
    w[: B // 2] = np.abs(w[: B // 2]) + 0.1
    if exact:
        data, q, w = _round(data, 8), _round(q, 8), _round(w, 4)
    return data, q, w


def _leaves(jindex):
    s = jindex.state
    return {
        "folded": np.asarray(s.tables.folded),
        "offsets": np.asarray(s.tables.offsets),
        "mixers": np.asarray(s.mixers),
        "sorted_keys": np.asarray(s.sorted_keys),
        "perm": np.asarray(s.perm),
        "data": np.asarray(s.data),  # bf16 stays ml_dtypes here: from_numpy reads its bits
        "levels": np.asarray(s.levels),
        "scales": None if s.scales is None else np.asarray(s.scales),
    }


def _both(family, storage, data, seed):
    kw = dict(d=D, M=M, K=K, L=L, family=family, W=32.0, max_candidates=C, storage=storage)
    jcfg = japi.IndexConfig(space=JSpace(0.0, 1.0, float(M)), **kw)
    tcfg = tapi.IndexConfig(space=TSpace(0.0, 1.0, float(M)), **kw)
    jidx = japi.Index.build(jax.random.PRNGKey(seed), data, jcfg)
    tidx = tapi.Index.from_numpy(_leaves(jidx), tcfg, device="cpu")
    return jidx, tidx


def _query_both(jidx, tidx, q, w, **spec):
    jres = jidx.query(q, w, japi.QuerySpec(k=TOPK, **spec))
    tres = tidx.query(torch.from_numpy(q), torch.from_numpy(w), tapi.QuerySpec(k=TOPK, **spec))
    jd, ji, jn = (np.asarray(x) for x in (jres.dists, jres.ids, jres.n_candidates))
    td, ti, tn = (x.numpy() for x in (tres.dists, tres.ids, tres.n_candidates))
    assert td.shape == jd.shape and ti.dtype == np.int32
    assert np.array_equal(ti, ji)
    assert np.array_equal(tn, jn)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)
    return tres


@pytest.mark.parametrize("alpha", [0.0, 2.0])
@pytest.mark.parametrize("mode", ["probe", "exact"])
@pytest.mark.parametrize("family", ["theta", "l2"])
@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_quantized_engine_parity(storage, family, mode, alpha):
    data, q, w = _inputs(5)
    jidx, tidx = _both(family, storage, data, seed=5)
    assert tidx.state.data.dtype == TORCH_DTYPES[storage]
    assert (tidx.state.scales is not None) == (storage == "int8")
    assert tidx.table_bytes == jidx.table_bytes
    tres = _query_both(jidx, tidx, q, w, mode=mode, screen_alpha=alpha)
    if mode == "probe":  # the probe really prunes, and finds something
        assert 0 < tres.n_candidates.float().mean() < N


@pytest.fixture
def exact_tables(monkeypatch):
    """Round the reference's folded tables to multiples of 2**-8, so every
    projection and multiprobe score is exact in f32 (the JAX package itself
    is untouched)."""
    orig = jhf.make_prefix_tables

    def rounded(key, params, dtype=None):
        t = orig(key, params) if dtype is None else orig(key, params, dtype=dtype)
        return jhf.PrefixTables(folded=jnp.asarray(_round(t.folded, 8)), offsets=t.offsets)

    monkeypatch.setattr(jhf, "make_prefix_tables", rounded)


@pytest.mark.parametrize("alpha", [0.0, 2.0])
@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_multiprobe_engine_parity(storage, alpha, exact_tables):
    data, q, w = _inputs(6, exact=True)
    jidx, tidx = _both("theta", storage, data, seed=6)
    probe = _query_both(jidx, tidx, q, w, mode="probe", screen_alpha=alpha)
    mp = _query_both(jidx, tidx, q, w, mode="multiprobe", n_probes=8, max_flips=3,
                     screen_alpha=alpha)
    # the own bucket is the first probe: multiprobe sees a superset
    assert torch.all(mp.n_candidates >= probe.n_candidates)
    assert mp.n_candidates.float().mean() > probe.n_candidates.float().mean()


@pytest.mark.parametrize("n_probes,max_flips", [(8, 3), (5, 1), (100, 2)])
def test_multiprobe_keys_bit_equal(n_probes, max_flips, exact_tables):
    data, q, w = _inputs(7, exact=True)
    jidx, tidx = _both("theta", "f32", data, seed=7)
    jk, jr = j_mp_keys(jidx.state, jnp.asarray(q), jnp.asarray(w), jidx.config, n_probes,
                       max_flips, with_ranks=True)
    tk, tr = t_mp_keys(tidx.state, torch.from_numpy(q), torch.from_numpy(w), tidx.config,
                       n_probes, max_flips, with_ranks=True)
    assert tk.dtype == tr.dtype == torch.int32
    assert tk.shape == jk.shape  # (b, L, P), P clamped to the reachable subsets
    assert np.array_equal(tk.numpy(), np.asarray(jk))
    assert np.array_equal(tr.numpy(), np.asarray(jr))
    only = t_mp_keys(tidx.state, torch.from_numpy(q), torch.from_numpy(w), tidx.config,
                     n_probes, max_flips)
    assert torch.equal(only, tk)


@pytest.mark.parametrize("Kb,max_flips,n_probes", [(12, 3, 8), (12, 3, 400), (31, 2, 40),
                                                  (5, 5, 32), (12, 0, 8), (12, 1, 1)])
def test_multiprobe_keys_dispatch_on_cpu_is_the_plain_version(Kb, max_flips, n_probes):
    """``ops.multiprobe_keys`` on CPU tensors runs the plain version, which
    gives the reference family's keys, and launches no kernel."""
    from repro.core.families import THETA as JTHETA
    from repro_torch.core.families import THETA as TTHETA
    from repro_torch.kernels import _build
    from repro_torch.kernels import ref as tref

    rs = np.random.default_rng(Kb * 100 + max_flips * 10 + n_probes)
    proj = (rs.integers(-1024, 1025, (6, 4, Kb)) / 256).astype(np.float32)
    before = _build.launch_counts()["multiprobe_keys"]
    got = tops.multiprobe_keys(torch.from_numpy(proj), n_probes, max_flips)
    assert got.dtype == torch.int32
    assert torch.equal(got, tref.multiprobe_keys(torch.from_numpy(proj), n_probes, max_flips))
    assert torch.equal(got, TTHETA.multiprobe_keys(torch.from_numpy(proj), n_probes, max_flips))
    assert np.array_equal(got.numpy(),
                          np.asarray(JTHETA.multiprobe_keys(jnp.asarray(proj), n_probes,
                                                            max_flips)))
    assert _build.launch_counts()["multiprobe_keys"] == before


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_candidates_do_not_depend_on_the_codec(family):
    """Hashing sees the raw rows, so the port's own builds from one seed
    probe the same candidates whatever the storage."""
    data, q, w = _inputs(8)
    counts = []
    for storage in ("f32", "bf16", "int8"):
        cfg = tapi.IndexConfig(d=D, M=M, K=K, L=L, family=family, W=32.0, max_candidates=C,
                               storage=storage, space=TSpace(0.0, 1.0, float(M)))
        idx = tapi.Index.build(3, data, cfg, device="cpu")
        res = idx.query(q, w, tapi.QuerySpec(k=TOPK, screen_alpha=2.0))
        counts.append(res.n_candidates)
        assert idx.table_bytes == N * D * tquant.bytes_per_value(storage) + (
            4 * D if storage == "int8" else 0
        )
    assert torch.equal(counts[0], counts[1]) and torch.equal(counts[0], counts[2])


def test_f32_screen_is_folded_away():
    """f32 storage ignores screen_alpha: α=2 returns what α=0 returns."""
    data, q, w = _inputs(9)
    cfg = tapi.IndexConfig(d=D, M=M, K=K, L=L, max_candidates=C,
                           space=TSpace(0.0, 1.0, float(M)))
    idx = tapi.Index.build(4, data, cfg, device="cpu")
    a = idx.query(q, w, tapi.QuerySpec(k=TOPK))
    b = idx.query(q, w, tapi.QuerySpec(k=TOPK, screen_alpha=2.0))
    assert torch.equal(a.ids, b.ids) and torch.equal(a.dists, b.dists)


def test_multiprobe_refusals_match_reference():
    data, q, w = _inputs(10)
    jidx, tidx = _both("l2", "f32", data, seed=10)
    with pytest.raises(ValueError, match="does not support multiprobe") as te:
        t_mp_keys(tidx.state, torch.from_numpy(q), torch.from_numpy(w), tidx.config, 8, 3)
    with pytest.raises(ValueError, match="does not support multiprobe") as je:
        j_mp_keys(jidx.state, jnp.asarray(q), jnp.asarray(w), jidx.config, 8, 3)
    assert str(te.value) == str(je.value)
    from repro.core.families import L2 as JL2
    from repro_torch.core.families import L2 as TL2

    with pytest.raises(NotImplementedError) as te:
        TL2.multiprobe_keys(torch.zeros((1, L, K)), 8, 3)
    with pytest.raises(NotImplementedError) as je:
        JL2.multiprobe_keys(jnp.zeros((1, L, K)), 8, 3)
    assert str(te.value) == str(je.value)
    # more probes than K=8 bits with max_flips=1 can reach (1 + 8 = 9)
    theta = tapi.Index.build(0, data, tapi.IndexConfig(
        d=D, M=M, K=K, L=L, max_candidates=C, space=TSpace(0.0, 1.0, float(M))), device="cpu")
    with pytest.raises(ValueError, match="exceeds the 9 distinct probe keys"):
        theta.query(q, w, tapi.QuerySpec(k=TOPK, mode="multiprobe", n_probes=10, max_flips=1))


def test_flip_subsets_match_reference():
    from repro.core.families import flip_subsets as j_flip
    from repro.core.families import n_flip_subsets as j_nflip
    from repro_torch.core.families import flip_subsets as t_flip
    from repro_torch.core.families import n_flip_subsets as t_nflip

    for Kb, f in ((1, 0), (4, 2), (8, 3), (12, 3), (3, 5)):
        assert t_nflip(Kb, f) == j_nflip(Kb, f)
        assert np.array_equal(t_flip(Kb, f).numpy(), np.asarray(j_flip(Kb, f)))


def test_from_numpy_checks_the_payload_dtype():
    data, _, _ = _inputs(11)
    jidx, _ = _both("theta", "int8", data, seed=11)
    leaves = _leaves(jidx)
    cfg = dict(d=D, M=M, K=K, L=L, max_candidates=C, space=TSpace(0.0, 1.0, float(M)))
    with pytest.raises(ValueError, match="stores torch.bfloat16"):
        tapi.Index.from_numpy(dict(leaves, scales=None), tapi.IndexConfig(storage="bf16", **cfg),
                              device="cpu")
    with pytest.raises(ValueError, match="needs scales"):
        tapi.Index.from_numpy(dict(leaves, scales=None), tapi.IndexConfig(storage="int8", **cfg),
                              device="cpu")
    # a bf16 payload arrives as ml_dtypes bfloat16 and keeps its bits
    jb, _ = _both("theta", "bf16", data, seed=11)
    lb = _leaves(jb)
    assert lb["data"].dtype.name == "bfloat16"
    tb = tapi.Index.from_numpy(lb, tapi.IndexConfig(storage="bf16", **cfg), device="cpu")
    assert np.array_equal(_bits(tb.state.data), _bits(lb["data"]))
