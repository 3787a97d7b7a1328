"""The plain reference against a brute-force weighted-L1 top-k, and its
pieces against their definitions, at a tiny size on the CPU."""

import itertools

import numpy as np
import pytest
import torch

from portbench.references import wl1_alsh as R

INDEX = dict(M=32, K=6, L=4, family="theta", W=8.0, max_candidates=512,
             space=[0.0, 1.0, 32.0], storage="f32")


def _inputs(n=512, d=8, b=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=g)
    q = torch.rand((b, d), generator=g)
    w = 1.0 + 0.1 * torch.randn((b, d), generator=g).abs()
    return x, q, w


def _brute(x, q, w, k):
    dist = (w.double()[:, None, :] * (x.double()[None] - q.double()[:, None]).abs()).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), dist.shape), dist.numpy()), axis=1)
    return np.take_along_axis(dist.numpy(), order, 1)[:, :k], order[:, :k]


@pytest.mark.parametrize("k", [1, 10])
def test_exact_equals_brute_force(k):
    x, q, w = _inputs()
    ref = R.Reference(x, 7, x.shape[1], INDEX)
    d, i = ref.exact(q, w, k, rows_per_block=100)
    bd, bi = _brute(x, q, w, k)
    np.testing.assert_array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_probe_with_windows_over_every_row_equals_brute_force():
    x, q, w = _inputs()
    ref = R.Reference(x, 7, x.shape[1], INDEX)
    # one table whose every key is probed sees all n rows
    keys = torch.arange(2 ** INDEX["K"])[None, None, :].expand(q.shape[0], 1, -1)
    ref.sorted = ref.sorted[:1]
    cand, count = ref.candidates(keys)
    assert (count == x.shape[0]).all()
    d, i = ref.topk(q, w, cand, 10)
    bd, bi = _brute(x, q, w, 10)
    np.testing.assert_array_equal(i.numpy(), bi)
    np.testing.assert_allclose(d.numpy(), bd, rtol=1e-12)


def test_candidates_are_the_first_C_rows_of_each_bucket():
    x, q, w = _inputs(n=300)
    index = dict(INDEX, K=2, L=3, max_candidates=5)
    ref = R.Reference(x, 3, x.shape[1], index)
    g = ref.g
    data_keys = R.pack_keys(R.project(R.levels_of(x, g), ref.table, g), g)  # (n, L)
    keys = ref.keys(q, w)
    cand, count = ref.candidates(keys)
    for b in range(q.shape[0]):
        want = set()
        for table in range(g.L):
            bucket = torch.nonzero(data_keys[:, table] == keys[b, table, 0]).flatten()
            want.update(bucket[: g.C].tolist())
        assert count[b] == len(want)
        assert cand[b, : len(want)].tolist() == sorted(want)
        assert (cand[b, len(want):] == x.shape[0]).all()


def test_projection_is_the_folded_table_sum():
    x, q, w = _inputs(n=20, d=5)
    g = R.Geometry(5, dict(INDEX, K=3, L=2))
    folded = R.draw_folded(11, g).double()
    lv = R.levels_of(q, g)
    table = folded.permute(1, 2, 0).reshape(-1, g.H)
    got = R.project(lv, table, g, weights=w)
    want = torch.stack([sum(w[:, i].double() * folded[h, i, lv[:, i]] for i in range(5))
                        for h in range(g.H)], dim=1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_flip_masks_and_probe_order():
    masks = R.flip_masks(5, 2)
    subsets = [()] + list(itertools.combinations(range(5), 1)) + list(
        itertools.combinations(range(5), 2))
    assert [tuple(torch.nonzero(m).flatten().tolist()) for m in masks] == subsets
    g = R.Geometry(4, dict(INDEX, K=5, L=1))
    proj = torch.tensor([[0.5, -0.1, 2.0, -3.0, 0.05]], dtype=torch.float64)
    keys = R.probe_keys(proj, g, 3, 2)
    base = 0b10101  # bits 0, 2 and 4 are >= 0
    assert keys[0, 0].tolist() == [base, base ^ 0b10000, base ^ 0b00010]


def test_draw_is_the_programs_draw():
    from repro_torch.core.hash_families import make_prefix_tables
    from repro_torch.core.index import IndexConfig
    from repro_torch.core.transforms import BoundedSpace

    cfg = IndexConfig(d=8, M=32, K=6, L=4, space=BoundedSpace(0.0, 1.0, 32.0))
    seed = 2**40 + 123
    prog = make_prefix_tables(torch.Generator().manual_seed(seed), cfg.lsh_params).folded
    assert torch.equal(R.draw_folded(seed, R.Geometry(8, INDEX)), prog)


def test_bf16_control_differs():
    x, q, w = _inputs()
    f64 = R.Reference(x, 7, x.shape[1], INDEX)
    bf16 = R.Reference(x, 7, x.shape[1], INDEX, precision="bf16")
    assert bf16.sorted.shape == f64.sorted.shape
    d64, _ = f64.exact(q, w, 10)
    d16, _ = bf16.exact(q, w, 10)
    assert ((d16.double() - d64).abs() / d64).max() > 1e-3
