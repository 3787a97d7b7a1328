"""Port parity: discretization, hash codes, key combining, the Eq 28 fold and
the plain ALSH projection of ``repro_torch`` against the JAX package, on the
same numpy inputs (CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import families as jfam
from repro.core import hash_families as jhf
from repro.core import transforms as jtr
from repro.kernels import ref as jref
from repro_torch.core import families as tfam
from repro_torch.core import hash_families as thf
from repro_torch.core import transforms as ttr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

# projections are f32 sums in a different order: a few ulps of the sum's size
PROJ_RTOL = 1e-5
PROJ_ATOL = 1e-4


@pytest.mark.parametrize("lo,hi,t", [(0.0, 1.0, 32.0), (-2.0, 3.0, 7.5), (0.0, 1.0, 13.0)])
def test_discretize_bit_equal(lo, hi, t):
    rs = np.random.default_rng(1)
    x = rs.uniform(lo - 0.2, hi + 0.2, (257, 19)).astype(np.float32)
    x[0, :4] = [lo, hi, np.nextafter(np.float32(hi), np.float32(0)), (lo + hi) / 2]
    want = np.asarray(jtr.discretize(jnp.asarray(x), jtr.BoundedSpace(lo, hi, t)))
    got = ttr.discretize(torch.from_numpy(x), ttr.BoundedSpace(lo, hi, t)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_codes_from_projections_equal(family):
    rs = np.random.default_rng(2)
    proj = rs.normal(0, 20, (64, 24)).astype(np.float32)
    proj[0, :3] = [0.0, -0.0, 1e-30]
    offsets = rs.uniform(0, 4.0, (24,)).astype(np.float32)
    want = jfam.get_family(family).codes_from_projections(
        jnp.asarray(proj), jnp.asarray(offsets), 4.0
    )
    got = tfam.get_family(family).codes_from_projections(
        torch.from_numpy(proj), torch.from_numpy(offsets), 4.0
    )
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize(
    "family,code_lo,code_hi",
    [
        ("theta", 0, 2),
        ("l2", -50, 50),
        ("l2", -(2**20), 2**20),  # products and sums far past int32: must wrap
    ],
)
def test_combine_codes_equal(family, code_lo, code_hi):
    rs = np.random.default_rng(3)
    L, K = 6, 12
    codes = rs.integers(code_lo, code_hi, (33, L, K), dtype=np.int32)
    mixers = (rs.integers(1, 2**31 - 1, (L, K), dtype=np.int64) | 1).astype(np.int32)
    want = np.asarray(
        jfam.get_family(family).combine_codes(jnp.asarray(codes), jnp.asarray(mixers), K)
    )
    got = tfam.get_family(family).combine_codes(
        torch.from_numpy(codes), torch.from_numpy(mixers), K
    )
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_combine_codes_l2_overflow_case_really_wraps():
    codes = np.full((1, 1, 2), 2**20, np.int32)
    mixers = np.full((1, 2), 2**30 + 1, np.int32)
    exact = 2 * (2**20) * (2**30 + 1)
    got = int(tfam.L2.combine_codes(torch.from_numpy(codes), torch.from_numpy(mixers), 2)[0, 0])
    assert got != exact and (got - exact) % 2**32 == 0
    want = int(np.asarray(jfam.L2.combine_codes(jnp.asarray(codes), jnp.asarray(mixers), 2))[0, 0])
    assert got == want


@pytest.mark.parametrize("d,M", [(1, 1), (5, 8), (16, 32)])
def test_prefix_tables_from_rows_match(d, M):
    rs = np.random.default_rng(4)
    a = rs.normal(size=(3, 2 * d, M)).astype(np.float32)
    want = np.stack([np.asarray(jhf._prefix_tables_from_rows(jnp.asarray(r))) for r in a])
    got = thf._prefix_tables_from_rows(torch.from_numpy(a)).numpy()
    assert got.shape == (3, d, M + 1)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_make_prefix_tables_shapes_and_determinism():
    params = thf.LSHParams(d=7, M=9, n_hashes=12, family="l2", W=3.0)
    t1 = thf.make_prefix_tables(torch.Generator().manual_seed(5), params)
    t2 = thf.make_prefix_tables(torch.Generator().manual_seed(5), params)
    assert t1.folded.shape == (12, 7, 10) and t1.offsets.shape == (12,)
    assert torch.equal(t1.folded, t2.folded) and torch.equal(t1.offsets, t2.offsets)
    assert float(t1.offsets.min()) >= 0.0 and float(t1.offsets.max()) <= 3.0


@pytest.mark.parametrize("weighted", [None, "positive", "mixed"])
@pytest.mark.parametrize("n,d,H,M", [(1, 1, 1, 1), (37, 13, 24, 8), (130, 16, 40, 32)])
def test_plain_alsh_project_matches_reference(n, d, H, M, weighted):
    rs = np.random.default_rng(n + d + H)
    levels = rs.integers(0, M + 1, (n, d), dtype=np.int32)
    folded = rs.normal(size=(H, d, M + 1)).astype(np.float32)
    w = None
    if weighted == "positive":
        w = rs.uniform(0.1, 2.0, (n, d)).astype(np.float32)
    elif weighted == "mixed":
        w = rs.normal(size=(n, d)).astype(np.float32)  # negative weights included
    want = np.asarray(
        jref.alsh_project(
            jnp.asarray(levels), jnp.asarray(folded), None if w is None else jnp.asarray(w)
        )
    )
    got = tops.alsh_project(
        torch.from_numpy(levels),
        torch.from_numpy(folded),
        None if w is None else torch.from_numpy(w),
    )
    assert got.shape == (n, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=PROJ_RTOL, atol=PROJ_ATOL)


def test_plain_alsh_project_chunks(monkeypatch):
    """The plain version chunks its (H, rows, d) gather; chunk edges must
    not change results."""
    rs = np.random.default_rng(9)
    levels = torch.from_numpy(rs.integers(0, 9, (50, 6), dtype=np.int32))
    folded = torch.from_numpy(rs.normal(size=(5, 6, 9)).astype(np.float32))
    w = torch.from_numpy(rs.normal(size=(50, 6)).astype(np.float32))
    whole = tref.alsh_project(levels, folded, w)
    monkeypatch.setattr(tref, "CHUNK_ELEMS", 5 * 6 * 7)  # 7-row chunks
    assert torch.equal(tref.alsh_project(levels, folded, w), whole)
