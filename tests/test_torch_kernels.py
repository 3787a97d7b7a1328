"""Port parity: the plain versions of the fused top-k kernels and the probe
primitives of ``repro_torch`` against the JAX package's oracles, over the
JAX package's own shape sweeps (CPU). Same bar as tests/test_kernels_topk.py:
ids equal, dists within rtol/atol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.index import _dedupe_candidates as j_dedupe
from repro.core.index import _probe_one_table as j_probe
from repro.kernels import ref as jref
from repro_torch.core.index import _dedupe_candidates as t_dedupe
from repro_torch.core.index import _probe_one_table as t_probe
from repro_torch.core.index import table_window_sizes as t_windows
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# the JAX package's sweeps (tests/test_kernels_topk.py): block-exact,
# off-by-one, sub-block, k > n
SCAN_TOPK_SHAPES = [
    (1, 1, 1, 1),
    (33, 3, 7, 5),
    (128, 8, 256, 128),
    (129, 9, 257, 10),
    (300, 5, 16, 3),
    (4, 2, 2, 8),
]
GATHER_SHAPES = [
    (50, 3, 17, 7, 5),
    (200, 2, 64, 128, 10),
    (8, 2, 40, 5, 3),  # more slots than rows
    (10, 2, 16, 300, 4),
    (5, 1, 1, 1, 1),
]


def _close(got, want):
    gd, gi = (t.numpy() for t in got)
    wd, wi = (np.asarray(t) for t in want)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5)
    assert np.array_equal(gi, wi)
    assert np.array_equal(gi == -1, ~np.isfinite(gd))


@pytest.mark.parametrize("n,b,d,k", SCAN_TOPK_SHAPES)
def test_plain_scan_topk_matches_reference(n, b, d, k):
    rs = np.random.default_rng(n * 31 + b * 7 + d + k)
    data = rs.normal(size=(n, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)
    want = jref.wl1_scan_topk(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), k)
    got = tops.wl1_scan_topk(torch.from_numpy(data), torch.from_numpy(q), torch.from_numpy(w), k)
    _close(got, want)


def test_plain_scan_topk_chunks_and_ties(monkeypatch):
    """Duplicate rows tie exactly; ties must go to the lower id, across
    chunk boundaries too."""
    rs = np.random.default_rng(11)
    base = rs.normal(size=(20, 6)).astype(np.float32)
    data = np.concatenate([base, base, base])  # every distance appears 3 times
    q = rs.normal(size=(4, 6)).astype(np.float32)
    w = np.abs(rs.normal(size=(4, 6))).astype(np.float32)
    want = jref.wl1_scan_topk(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), 9)
    monkeypatch.setattr(tref, "CHUNK_ELEMS", 4 * 6 * 7)  # 7-row chunks
    got = tops.wl1_scan_topk(torch.from_numpy(data), torch.from_numpy(q), torch.from_numpy(w), 9)
    _close(got, want)


@pytest.mark.parametrize("n,b,P,d,k", GATHER_SHAPES)
def test_plain_gather_rerank_matches_reference(n, b, P, d, k):
    rs = np.random.default_rng(n + P * 13 + d + k)
    data = rs.normal(size=(n, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)
    ids = np.minimum(rs.integers(0, n + max(2, n // 3), (b, P)), n).astype(np.int32)
    want = jref.gather_rerank_topk(
        jnp.asarray(data), jnp.asarray(ids), jnp.asarray(q), jnp.asarray(w), k
    )
    got = tops.gather_rerank_topk(
        torch.from_numpy(data), torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(w), k
    )
    _close(got, want)


@pytest.mark.parametrize("chunk_rows", [None, 3])
def test_plain_gather_rerank_all_invalid_and_packed(monkeypatch, chunk_rows):
    """An all-sentinel row returns (+inf, -1); a deduped (packed) row gives
    the reference's answer whatever the chunking."""
    rs = np.random.default_rng(12)
    n, b, d, k = 30, 3, 8, 6
    data = rs.normal(size=(n, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = np.abs(rs.normal(size=(b, d))).astype(np.float32) + 0.1
    half = rs.integers(0, n, (b, 10))
    cand = np.concatenate([half, half, np.full((b, 4), n + 3)], axis=1).astype(np.int32)
    cand[0] = n  # every slot of query 0 is a sentinel
    packed, _ = j_dedupe(jnp.asarray(cand), n)
    packed = np.array(packed)
    if chunk_rows:
        monkeypatch.setattr(tref, "CHUNK_ELEMS", b * d * chunk_rows)
    want = jref.gather_rerank_topk(
        jnp.asarray(data), jnp.asarray(packed), jnp.asarray(q), jnp.asarray(w), k
    )
    got = tops.gather_rerank_topk(
        torch.from_numpy(data), torch.from_numpy(packed), torch.from_numpy(q),
        torch.from_numpy(w), k,
    )
    _close(got, want)
    assert np.all(got[1][0].numpy() == -1) and np.all(np.isinf(got[0][0].numpy()))


@pytest.mark.parametrize("n,P", [
    (30, 24), (100, 7), (5, 40),
    (270_336, 1034),  # a stream group: k + G·C = 10 + 8·128 slots, n + cap ids
    (270_336, 12_288),  # the two-segment block: L·C + cap = 32·128 + 8192 slots
])
def test_dedupe_candidates_equal(n, P):
    rs = np.random.default_rng(n * P)
    cand = rs.integers(0, n + 9, (6, P)).astype(np.int32)
    cand[1] = n + 5  # all invalid
    want_c, want_n = j_dedupe(jnp.asarray(cand), n)
    got_c, got_n = t_dedupe(torch.from_numpy(cand), n)
    assert got_c.dtype == torch.int32 and got_n.dtype == torch.int32
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.array_equal(got_n.numpy(), np.asarray(want_n))


def test_dedupe_candidates_on_cpu_takes_the_plain_version():
    """A CPU tensor runs the plain version and launches nothing."""
    from repro_torch.kernels import _build

    rs = np.random.default_rng(33)
    cand = torch.from_numpy(rs.integers(0, 60, (5, 70)).astype(np.int32))
    before = _build.launch_counts()["dedupe_candidates"]
    got = tops.dedupe_candidates(cand, 50)
    want = tref.dedupe_candidates(cand, 50)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[0], t_dedupe(cand, 50)[0])
    assert _build.launch_counts()["dedupe_candidates"] == before


@pytest.mark.parametrize("C", [1, 4, 16])
def test_probe_one_table_equal(C):
    rs = np.random.default_rng(C)
    L, n, b = 3, 40, 9
    keys_ln = rs.integers(-3, 4, (L, n)).astype(np.int32)  # many duplicate keys
    perm = np.argsort(keys_ln, axis=1, kind="stable").astype(np.int32)
    sorted_keys = np.take_along_axis(keys_ln, perm, axis=1)
    perm = np.concatenate([perm, np.full((L, C), n, np.int32)], axis=1)
    qkeys = rs.integers(-5, 6, (b, L)).astype(np.int32)  # some keys hit no bucket
    probe = jax.vmap(jax.vmap(j_probe, in_axes=(0, 0, 0, None)), in_axes=(None, None, 0, None))
    want = np.asarray(probe(jnp.asarray(sorted_keys), jnp.asarray(perm), jnp.asarray(qkeys), C))
    got = t_probe(torch.from_numpy(sorted_keys), torch.from_numpy(perm),
                  torch.from_numpy(qkeys.T.copy()), C)
    assert np.array_equal(got.permute(1, 0, 2).numpy(), want)  # (b, L, C)
    sizes = t_windows(torch.from_numpy(sorted_keys), torch.from_numpy(qkeys)).numpy()
    from repro.core.index import table_window_sizes as j_windows

    assert np.array_equal(sizes, np.asarray(j_windows(jnp.asarray(sorted_keys),
                                                      jnp.asarray(qkeys))))


# the materializing scan and re-rank: ragged n, b, C and d (d past 256, the
# Pallas kernels' coordinate block), negative weights; bar rtol/atol 1e-4
# (tests/test_kernels_wl1.py)
WL1_SCAN_SHAPES = [(1, 1, 1), (129, 9, 257), (300, 5, 16), (37, 3, 300), (1000, 8, 130)]
WL1_RERANK_SHAPES = [(1, 1, 1), (3, 130, 257), (5, 7, 16), (2, 300, 100)]


@pytest.mark.parametrize("n,b,d", WL1_SCAN_SHAPES)
def test_plain_wl1_scan_matches_reference_and_pallas(n, b, d):
    from repro.kernels.wl1_distance import wl1_scan_pallas

    rs = np.random.default_rng(n * 7 + b + d)
    data = rs.normal(size=(n, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)  # mixed signs
    got = tops.wl1_scan(torch.from_numpy(data), torch.from_numpy(q), torch.from_numpy(w))
    assert got.shape == (b, n) and got.dtype == torch.float32
    for want in (jref.wl1_scan(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w)),
                 wl1_scan_pallas(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w),
                                 interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,C,d", WL1_RERANK_SHAPES)
def test_plain_wl1_rerank_matches_reference_and_pallas(b, C, d):
    from repro.kernels.wl1_distance import wl1_rerank_pallas

    rs = np.random.default_rng(b * 5 + C + d)
    pts = rs.normal(size=(b, C, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)  # mixed signs
    got = tops.wl1_rerank(torch.from_numpy(pts), torch.from_numpy(q), torch.from_numpy(w))
    assert got.shape == (b, C) and got.dtype == torch.float32
    for want in (jref.wl1_rerank(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(w)),
                 wl1_rerank_pallas(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(w),
                                   interpret=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_plain_wl1_scan_and_rerank_chunk(monkeypatch):
    """Chunk boundaries that split rows and candidates give the unchunked answer."""
    rs = np.random.default_rng(21)
    data = torch.from_numpy(rs.normal(size=(50, 6)).astype(np.float32))
    q = torch.from_numpy(rs.normal(size=(3, 6)).astype(np.float32))
    w = torch.from_numpy(rs.normal(size=(3, 6)).astype(np.float32))
    pts = data[:40].reshape(1, 40, 6).expand(3, 40, 6).contiguous()
    scan, rerank = tops.wl1_scan(data, q, w), tops.wl1_rerank(pts, q, w)
    monkeypatch.setattr(tref, "CHUNK_ELEMS", 3 * 6 * 7)  # 7 rows / candidates per chunk
    assert torch.equal(tops.wl1_scan(data, q, w), scan)
    assert torch.equal(tops.wl1_rerank(pts, q, w), rerank)
    assert torch.equal(rerank, scan[:, :40])


def test_distance_helpers_match_reference():
    from repro.distance import wl1 as jd
    from repro_torch.distance import wl1 as td

    rs = np.random.default_rng(13)
    O = rs.normal(size=(40, 6)).astype(np.float32)
    Q = rs.normal(size=(3, 6)).astype(np.float32)
    W = rs.normal(size=(3, 6)).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(td.pairwise_wl1(t(O), t(Q), t(W)).numpy(),
                               np.asarray(jd.pairwise_wl1(O, Q, W)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(td.wl1_distance(t(O), t(Q[0]), t(W[0])).numpy(),
                               np.asarray(jd.wl1_distance(O, Q[0], W[0])), rtol=1e-5, atol=1e-5)
    for q, w in ((Q, W), (Q[0], W[0])):  # batched and single query
        got = td.brute_force_nn(t(O), t(q), t(w), k=4)
        want = jd.brute_force_nn(O, q, w, k=4)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    ids = np.array([[0, 1, -1], [4, 5, 6]])
    ref = np.array([[1, 2, 3], [6, 5, 9]])
    assert td.recall_at_k(t(ids), ref) == jd.recall_at_k(ids, ref)


def test_unexplained_id_mismatches_counts_only_non_ties():
    """The near-tie rule chip_smoke.py and the CUDA tests use to compare a
    kernel's top-k ids with its plain version's."""
    data = torch.tensor([[1.0], [2.0], [2.0000001], [5.0], [5.0], [7.0]])
    q = torch.tensor([[0.0], [0.0]])
    w = torch.tensor([[1.0], [1.0]])
    want_d, want_i = tref.wl1_scan_topk(data, q, w, 4)
    assert want_i[0].tolist() == [0, 1, 2, 3]

    def count(got_i):
        return tref.unexplained_id_mismatches(torch.tensor(got_i, dtype=torch.int32), want_d,
                                              want_i, data, q, w, 1e-5, 1e-5)

    assert count([[0, 1, 2, 3], [0, 2, 1, 4]]) == 0  # a near-tie swap; a tie in the last slot
    assert count([[0, 1, 2, 5], [0, 1, 2, 3]]) == 1  # last slot: right distance, wrong id
    assert count([[0, 3, 2, 3], [0, 1, 2, -1]]) == 3  # no tie, a repeated id, a missing row
