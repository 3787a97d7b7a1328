"""The materializing scan's and re-rank's schedules (``csrc/wl1_distance.cu``)
replayed on the CPU.

The re-rank is the gathers' row body over contiguous rows: a warp takes 8
rows of one query, lane l sums the 4-coordinate chunks l, l+32, ... of each
row in one fmaf chain (VEC4; one coordinate per lane and step in the SCALAR
layout), and ``reduce_rows`` adds the 8 rows' lane partials over the warp in
the butterfly's pairs. The replay runs that lane by lane in float32 and is
held to the plain version, to the JAX package's Pallas kernel in interpret
mode, and bit for bit to the per-row butterfly of the gathers' model.

The scan walks a block's rows in 256-row tiles and each tile's coordinates
in 16-wide chunks; the host cuts the rows into ``scan_row_splits`` splits,
which must cover every row once in whole tiles with no empty split and keep
the kernel's row arithmetic within a C int. The replay's sequential fmaf
distances are held to the plain version and the Pallas kernel.

fmaf is modelled as the float64 product and sum rounded once to float32.
That is the fused result except for rare double roundings; the bit
comparisons below hold two replays that share their chains, so they do not
depend on it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wl1_distance import wl1_rerank_pallas, wl1_scan_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.wl1_distance import GRID_Y_MAX, MAX_ROWS, TILE_ROWS, scan_row_splits

LANES = np.arange(32)
U = 8  # re-rank: rows per warp (gather_rerank.cuh's U)
RR_WARPS = 8  # re-rank: warps per block, as in csrc/wl1_distance.cu
DK = 16  # scan: coordinates per staged chunk, as in csrc/wl1_distance.cu
TOL = 1e-5  # f32 sums of d <= 256 terms of magnitude ~1 in different orders


def _fmaf(w, x, p):
    return (np.asarray(w, np.float64) * x.astype(np.float64) + p).astype(np.float32)


def _chains(rows, q, w, vec4):
    """(8, d) rows -> (8, 32) lane partials of one warp batch: lane l's chain
    over its chunks (VEC4) or coordinates (SCALAR), in the kernel's order."""
    d = rows.shape[1]
    width = 4 if vec4 else 1
    nv = d // width
    part = np.zeros((U, 32), np.float32)
    for j0 in range(0, nv, 32):
        j = j0 + LANES
        live = j < nv
        for t in range(width):
            c = np.where(live, width * j + t, 0)
            step = _fmaf(w[c], np.abs(rows[:, c] - q[c]), part)
            part = np.where(live, step, part)
    return part


def _reduce_half(x, bit):
    n = x.shape[0] // 2
    upper = (LANES & bit) != 0
    keep = np.where(upper, x[n:], x[:n])
    send = np.where(upper, x[:n], x[n:])
    return keep + send[:, LANES ^ bit]


def _reduce_rows(part):
    """reduce_rows over (8, 32) partials: lane l ends with row (l >> 2) & 7."""
    s = _reduce_half(_reduce_half(_reduce_half(part, 16), 8), 4)[0]
    for off in (2, 1):
        s = s + s[LANES ^ off]
    return s


def _butterfly(x):
    v = x.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0]


def _rerank_batches(C):
    """The kernel's grid: (block, warp) -> the warp's first row and row count."""
    rows = RR_WARPS * U
    for blk in range(-(-C // rows)):
        for warp in range(RR_WARPS):
            u0 = blk * rows + warp * U
            if u0 < C:
                yield u0, min(U, C - u0)


def _replay_rerank(pts, q, w, vec4, butterfly=False):
    b, C, d = pts.shape
    out = np.full((b, C), np.nan, np.float32)
    for qi in range(b):
        for u0, nr in _rerank_batches(C):
            rows = np.zeros((U, d), np.float32)
            rows[:nr] = pts[qi, u0:u0 + nr]
            part = _chains(rows, q[qi], w[qi], vec4)
            if butterfly:
                dist = np.array([_butterfly(p) for p in part], np.float32)
            else:
                dist = _reduce_rows(part)[4 * LANES[:U]]  # lane 4u holds row u
            out[qi, u0:u0 + nr] = dist[:nr]
    return out


def _inputs(seed, b, C, d):
    rs = np.random.default_rng(seed)
    pts = rs.normal(size=(b, C, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)  # negative weights too
    return pts, q, w


@pytest.mark.parametrize(
    "d,vec4", [(4, True), (16, True), (128, True), (256, True), (130, False), (33, False)]
)
def test_rerank_replay_matches_plain_pallas_and_the_butterfly(d, vec4):
    """b=2, C=75: one full block of 64 rows and a ragged one (a warp of 8,
    then one of 3)."""
    pts, q, w = _inputs(d, 2, 75, d)
    got = _replay_rerank(pts, q, w, vec4)
    assert not np.isnan(got).any()
    plain = ref.wl1_rerank(torch.from_numpy(pts), torch.from_numpy(q), torch.from_numpy(w))
    np.testing.assert_allclose(got, plain.numpy(), rtol=TOL, atol=TOL)
    pallas = wl1_rerank_pallas(jnp.asarray(pts), jnp.asarray(q), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=TOL, atol=TOL)
    want = _replay_rerank(pts, q, w, vec4, butterfly=True)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


INT_MAX = 2**31 - 1


def _rows_per_split(n, S):
    """The kernel's cut (wl1_scan_launch): ceil(tiles / S) tiles a split."""
    return -(-(-(-n // TILE_ROWS)) // S) * TILE_ROWS


@pytest.mark.parametrize(
    "n", [0, 1, 255, 256, 257, 65536, 262144, GRID_Y_MAX * TILE_ROWS,
          GRID_Y_MAX * TILE_ROWS + 1, 3 * GRID_Y_MAX * TILE_ROWS - 7, MAX_ROWS]
)
def test_scan_row_splits(n):
    S = scan_row_splits(n)
    tiles = -(-n // TILE_ROWS)
    assert 1 <= S <= GRID_Y_MAX
    if 0 < tiles <= GRID_Y_MAX:
        assert S == tiles  # one tile per block
    per = _rows_per_split(n, S)
    cuts = [(s * per, min(n, (s + 1) * per)) for s in range(S)]
    if n:
        assert all(a < z for a, z in cuts)  # no empty split
        assert cuts[-1][1] == n
        assert all(z == a2 for (_, z), (a2, _) in zip(cuts, cuts[1:]))
        assert all(a % TILE_ROWS == 0 for a, _ in cuts)
    # the kernel's int row arithmetic: n rounded up to a tile (and a tile's
    # last row), the last split's unclipped end
    assert n + TILE_ROWS - 1 <= INT_MAX
    assert S * per <= INT_MAX


def test_scan_row_splits_rejects_rows_past_the_int_limit():
    with pytest.raises(ValueError, match="at most"):
        scan_row_splits(MAX_ROWS + 1)


def _chunk_coords(d):
    """The coordinates a tile sums, in order: chunks of DK, the last one
    ragged (kmax = min(DK, d - c * DK)); one empty chunk when d == 0."""
    out = []
    for c in range(max(1, -(-d // DK))):
        out += [c * DK + kk for kk in range(min(DK, d - c * DK))]
    return out


@pytest.mark.parametrize("n,b,d", [(300, 5, 40), (257, 9, 16)])
def test_scan_replay_matches_plain_and_pallas(n, b, d):
    """Each distance one sequential fmaf chain over the chunk walk's
    coordinates."""
    rs = np.random.default_rng(n + b + d)
    data = rs.normal(size=(n, d)).astype(np.float32)
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = rs.normal(size=(b, d)).astype(np.float32)
    acc = np.zeros((b, n), np.float32)
    for c in _chunk_coords(d):
        acc = _fmaf(w[:, c:c + 1], np.abs(data[None, :, c] - q[:, c:c + 1]), acc)
    plain = ref.wl1_scan(torch.from_numpy(data), torch.from_numpy(q), torch.from_numpy(w))
    np.testing.assert_allclose(acc, plain.numpy(), rtol=TOL, atol=TOL)
    pallas = wl1_scan_pallas(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(acc, np.asarray(pallas), rtol=TOL, atol=TOL)
