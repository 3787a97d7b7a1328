"""Port parity of the remaining primitives (CPU): the unary embedding of
``core/transforms`` (Eq 19–21 and Observation 1's slack), the naive
projection vector and the two hash functions of ``core/hash_families``, and
the wl2 distance and ``brute_force_nn(distance=…)`` of ``distance/wl1``.

The same seeded numpy inputs go through the JAX function and its port.
Bar: the embeddings, codes and ids exactly; sums within rtol/atol 1e-5
(tests/test_kernels_topk.py). The §4.2.3 trick is held against the naive
O(Md) inner product with the explicit P/Q vectors, as
tests/test_hash_families.py holds the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.hash_families as jhf
import repro.core.transforms as jtr
import repro.distance.wl1 as jwl
import repro_torch.core.hash_families as thf
import repro_torch.core.transforms as ttr
import repro_torch.distance as tdist
import repro_torch.distance.wl1 as twl

RTOL = ATOL = 1e-5
SHAPES = [(1, 1, 1), (3, 5, 4), (7, 12, 16), (16, 33, 9)]  # (batch, d, M)


def _levels(rs, b, d, M):
    return rs.integers(0, M + 1, size=(b, d)).astype(np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("b,d,M", SHAPES)
def test_unary_code_and_transforms_match(b, d, M):
    rs = np.random.default_rng(b * 100 + d)
    lv = _levels(rs, b, d, M)
    w = rs.normal(size=(b, d)).astype(np.float32)
    tl, tw = torch.from_numpy(lv), torch.from_numpy(w)
    v = ttr.unary_code(tl, M)
    assert v.dtype == torch.float32 and tuple(v.shape) == (b, d, M)
    np.testing.assert_array_equal(_np(v), np.asarray(jtr.unary_code(jnp.asarray(lv), M)))
    np.testing.assert_array_equal(_np(ttr.transform_P(tl, M)),
                                  np.asarray(jtr.transform_P(jnp.asarray(lv), M)))
    np.testing.assert_array_equal(_np(ttr.transform_Q(tl, tw, M)),
                                  np.asarray(jtr.transform_Q(jnp.asarray(lv), jnp.asarray(w), M)))


@pytest.mark.parametrize("b,d,M", SHAPES)
def test_wl1_via_mips_matches_reference_and_eq21(b, d, M):
    """Eq 21 in both packages, and against the weighted L1 distance on the
    lattice it encodes."""
    rs = np.random.default_rng(7 + b + d)
    lo, lq = _levels(rs, b, d, M), _levels(rs, b, d, M)
    w = rs.normal(size=(b, d)).astype(np.float32)
    got = ttr.wl1_via_mips(torch.from_numpy(lo), torch.from_numpy(lq), torch.from_numpy(w), M)
    want = jtr.wl1_via_mips(jnp.asarray(lo), jnp.asarray(lq), jnp.asarray(w), M)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL * M * d)
    direct = np.sum(w * np.abs(lo - lq), axis=-1)
    np.testing.assert_allclose(_np(got), direct, rtol=1e-4, atol=1e-4 * M * d)


@pytest.mark.parametrize("t", [1.0, 4.0, 32.0])
def test_discretization_slack_matches(t):
    rs = np.random.default_rng(int(t))
    w = rs.normal(size=(6, 10)).astype(np.float32)
    got = ttr.discretization_slack(torch.from_numpy(w), ttr.BoundedSpace(0.0, 1.0, t))
    want = jtr.discretization_slack(jnp.asarray(w), jtr.BoundedSpace(0.0, 1.0, t))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("d,M", [(1, 1), (4, 7), (12, 10), (16, 32)])
@pytest.mark.parametrize("weighted", [False, True], ids=["data", "query"])
def test_prefix_trick_matches_naive(d, M, weighted):
    """a^T P(o) and a^T Q_w(q) through the folded tables and the port's
    projection equal the naive 2Md inner product with
    ``naive_projection_vector``; the naive vector is the reference's."""
    rs = np.random.default_rng(d * 10 + M)
    H = 5
    a_rows = rs.normal(size=(H, 2 * d, M)).astype(np.float32)
    lv = _levels(rs, 6, d, M)
    w = rs.normal(size=(6, d)).astype(np.float32) if weighted else None
    folded = thf._prefix_tables_from_rows(torch.from_numpy(a_rows))
    tables = thf.PrefixTables(folded, torch.zeros(H))
    tl = torch.from_numpy(lv)
    got = (thf.project_query(tl, torch.from_numpy(w), tables) if weighted
           else thf.project_data(tl, tables))
    for h in range(H):
        a = thf.naive_projection_vector(torch.from_numpy(a_rows[h]))
        np.testing.assert_array_equal(_np(a), np.asarray(jhf.naive_projection_vector(
            jnp.asarray(a_rows[h]))))
        vec = ttr.transform_Q(tl, torch.from_numpy(w), M) if weighted else ttr.transform_P(tl, M)
        want = vec.double() @ a.double()
        np.testing.assert_allclose(_np(got[:, h]), _np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("W", [1.0, 4.0, 64.0])
def test_l2_and_sign_hash_match(W):
    rs = np.random.default_rng(int(W))
    H = 24
    proj = (rs.normal(size=(9, H)) * 10).astype(np.float32)
    proj[0, :4] = 0.0  # the sign hash's boundary: 0 hashes to 1
    offsets = rs.uniform(0, W, size=(H,)).astype(np.float32)
    folded = np.zeros((H, 2, 3), np.float32)
    ttab = thf.PrefixTables(torch.from_numpy(folded), torch.from_numpy(offsets))
    jtab = jhf.PrefixTables(folded=jnp.asarray(folded), offsets=jnp.asarray(offsets))
    got = thf.l2_hash(torch.from_numpy(proj), ttab, W)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(jhf.l2_hash(jnp.asarray(proj), jtab, W)))
    got = thf.sign_hash(torch.from_numpy(proj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(jhf.sign_hash(jnp.asarray(proj))))


def test_wl2_distance_matches():
    rs = np.random.default_rng(3)
    o = rs.normal(size=(5, 7, 9)).astype(np.float32)
    q = rs.normal(size=(5, 1, 9)).astype(np.float32)
    w = rs.normal(size=(5, 1, 9)).astype(np.float32)
    got = twl.wl2_distance(torch.from_numpy(o), torch.from_numpy(q), torch.from_numpy(w))
    want = jwl.wl2_distance(jnp.asarray(o), jnp.asarray(q), jnp.asarray(w))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    assert tdist.wl2_distance is twl.wl2_distance


@pytest.mark.parametrize("distance", ["wl1", "wl2"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batch"])
def test_brute_force_nn_matches(distance, batched):
    """Both distances through both packages; the data holds duplicate rows,
    so equal distances must go to the lower id as ``lax.top_k`` orders
    them."""
    rs = np.random.default_rng(11)
    data = rs.integers(0, 4, size=(300, 6)).astype(np.float32)  # many exact ties
    q = rs.integers(0, 4, size=(8, 6)).astype(np.float32)
    w = np.abs(rs.normal(size=(8, 6))).astype(np.float32) + 0.5
    if not batched:
        q, w = q[0], w[0]
    got_d, got_i = tdist.brute_force_nn(torch.from_numpy(data), torch.from_numpy(q),
                                        torch.from_numpy(w), k=12, distance=distance)
    want_d, want_i = jwl.brute_force_nn(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), k=12,
                                        distance=distance)
    assert tuple(got_i.shape) == tuple(np.shape(want_i)) and got_i.dtype == torch.int32
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))
    np.testing.assert_allclose(_np(got_d), np.asarray(want_d), rtol=RTOL, atol=ATOL)


def test_brute_force_nn_wl2_chunks_the_batch(monkeypatch):
    """A chunk budget under one query's (n, d) block gives the same answer."""
    from repro_torch.kernels import ref as tref

    rs = np.random.default_rng(12)
    data = torch.from_numpy(rs.normal(size=(64, 5)).astype(np.float32))
    q = torch.from_numpy(rs.normal(size=(7, 5)).astype(np.float32))
    w = torch.ones((7, 5))
    whole = tdist.brute_force_nn(data, q, w, k=4, distance="wl2")
    monkeypatch.setattr(tref, "CHUNK_ELEMS", 1)
    chunked = tdist.brute_force_nn(data, q, w, k=4, distance="wl2")
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
    with pytest.raises(ValueError, match="'wl1' or 'wl2'"):
        tdist.brute_force_nn(data, q, w, k=4, distance="l1")
