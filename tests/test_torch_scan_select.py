"""The scan's filter-then-select top-k and the projection's table relayout
on the CPU: the invariants the CUDA kernels rest on, held with the plain
versions' own arithmetic, and the host split function
(``repro_torch.kernels.wl1_topk.scan_splits``).

The scan kernel (``csrc/wl1_topk.cu``) cuts the rows into splits of whole
256-row tiles. Per query and split it keeps a sorted list of k (dist, id)
and tau, the list's k-th distance; after each tile the rows with dist < tau
go to a 32-entry buffer, and a full buffer (or the split's end) is folded
into the list: the buffer sorted, every entry placed at its own index plus
the other run's count of smaller keys. The splits' lists are merged by
(dist, id). The answer must be the whole top-k bit for bit: the k smallest
(dist, id) over all rows, which is what a stable top-k over id-ordered rows
keeps. The data here are quarter-integers and the weights small integers,
so every distance is exact in f32 whatever the order of its sum, and the
torch plain version, the JAX chunked scan and this schedule see the same
distances.
"""

import bisect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.wl1_topk import wl1_scan_topk_chunked
from repro_torch.kernels import ops, ref
from repro_torch.kernels.alsh_project import HASH_GROUP, tile_folded, untile_folded
from repro_torch.kernels.wl1_topk import (
    BLOCK_QUERIES,
    BLOCKS_PER_SM,
    CANDIDATE_BUFFER,
    MERGE_ENTRIES,
    SMEM_LIMIT,
    TILE_ROWS,
    scan_splits,
    smem_bytes,
)

EMPTY = 2**31 - 1  # the kernel's id of an empty list entry
INF = math.inf
K_MAX = max(k for k in range(1, 1024) if smem_bytes(k) <= SMEM_LIMIT)


def _fold(lst, buf, k):
    """The kernel's fold_buffer: lst is k sorted keys, buf unsorted."""
    buf = sorted(buf)
    out = [None] * k
    for j, key in enumerate(buf):
        r = j + bisect.bisect_left(lst, key)  # list keys below it
        if r < k:
            out[r] = key
    for j, key in enumerate(lst):
        r = j + bisect.bisect_left(buf, key)  # buffer keys below it
        if r < k:
            out[r] = key
    assert all(o is not None for o in out)  # the ranks are a permutation
    return out


def _lane_bound(groups, k):
    """The successor (in f32) of the k-th smallest of the tile's 32 lane
    minima: lane l holds rows row0 + l + 32 j."""
    minima = [min((g[lane][0] for g in groups if lane < len(g)), default=INF)
              for lane in range(32)]
    kth = np.float32(sorted(minima)[k - 1])
    return float(np.nextafter(kth, np.float32(np.inf)))


def _split_topk(dist, rb, re, k):
    """One query's list over rows [rb, re) as the partial kernel keeps it:
    the fast path appends a tile's survivors at once when they fit (when
    they do not and k <= 32, after filtering them by the lane-minimum
    bound too), the slow path walks the tile's eight 32-row groups and
    folds when the next group does not fit."""
    lst, tau, buf = [(INF, EMPTY)] * k, INF, []
    for row0 in range(rb, re, TILE_ROWS):
        groups = [[(float(dist[r]), r) for r in range(row0 + 32 * j, min(re, row0 + 32 * j + 32))]
                  for j in range(TILE_ROWS // 32)]
        survivors = [e for g in groups for e in g if e[0] < tau]
        if len(buf) + len(survivors) > CANDIDATE_BUFFER and k <= 32:
            tight = min(tau, _lane_bound(groups, k))
            survivors = [e for g in groups for e in g if e[0] < tight]
        if len(buf) + len(survivors) <= CANDIDATE_BUFFER:
            buf += survivors
            continue
        for g in groups:
            s = [e for e in g if e[0] < tau]
            if len(buf) + len(s) > CANDIDATE_BUFFER:
                lst, buf = _fold(lst, buf, k), []
                tau = lst[-1][0]
                s = [e for e in g if e[0] < tau]
            buf += s
    if buf:
        lst = _fold(lst, buf, k)
    return [(d, -1 if i == EMPTY else i) for d, i in lst]


def _schedule_topk(dists, k, sm_count):
    """The kernel's whole schedule over (b, n) distances: scan_splits
    splits of whole tiles, a list per (query, split), the (dist, id) merge."""
    b, n = dists.shape
    S = scan_splits(n, b, k, sm_count)
    tiles = -(-n // TILE_ROWS)
    per = -(-tiles // S) * TILE_ROWS
    out_d = torch.full((b, k), INF)
    out_i = torch.full((b, k), -1, dtype=torch.int32)
    for qi in range(b):
        entries = []
        for s in range(S):
            entries += [e for e in _split_topk(dists[qi], s * per, min(n, (s + 1) * per), k)
                        if e[1] >= 0]
        for j, (dv, i) in enumerate(sorted(entries)[:k]):
            out_d[qi, j], out_i[qi, j] = dv, i
    return S, (out_d, out_i)


def _exact_inputs(seed, n, b, d, dup=4, signed=True):
    """Quarter-integer rows, each repeated ``dup`` times n // dup rows apart
    (exact ties across tiles and splits); quarter-integer queries; integer
    weights, negative too when ``signed``."""
    rs = np.random.default_rng(seed)
    base = rs.integers(-8, 9, (max(1, n // dup), d)).astype(np.float32) / 4
    data = np.resize(base, (n, d))
    q = rs.integers(-8, 9, (b, d)).astype(np.float32) / 4
    lo = -3 if signed else 1
    w = rs.integers(lo, 4, (b, d)).astype(np.float32)
    return data, q, w


def _assert_bits(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize(
    "n,b,d,k,sm_count",
    [
        (2100, 70, 12, 10, 132),  # ties across tiles and splits, ragged n and b
        (2100, 70, 12, 10, 2),  # two splits of several tiles each
        (2100, 3, 5, 40, 132),  # k > one buffer: no lane-minimum bound
        (2100, 3, 5, 32, 132),  # the largest k with the bound
        (7, 3, 4, 10, 132),  # n < k
        (600, 5, 6, K_MAX, 132),  # k at the kernel's shared-memory limit
        (257, 65, 3, 1, 132),  # one row past a tile, one query past a tile
    ],
)
def test_filter_select_schedule_is_the_stable_topk(n, b, d, k, sm_count):
    data, q, w = _exact_inputs(n + b + d + k, n, b, d)
    dists = ref.wl1_scan(*(torch.from_numpy(x) for x in (data, q, w)))
    S, got = _schedule_topk(dists, k, sm_count)
    want = ref.wl1_scan_topk(*(torch.from_numpy(x) for x in (data, q, w)), k)
    _assert_bits(got, want)
    jd, ji = wl1_scan_topk_chunked(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), k, chunk=64)
    _assert_bits(got, (torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji))))
    if k > 1 and n >= 2 * k:  # equal distances sit in the answer: the ties are in play
        assert bool(((got[0][:, 1:] == got[0][:, :-1]) & torch.isfinite(got[0][:, 1:])).any())
    if sm_count == 2:
        assert S == 2


def test_filter_select_rows_at_infinity():
    """Rows at +inf never pass tau (from tau = +inf), so the slots past the
    finite rows are (+inf, -1), as the plain versions' sentinel rule gives."""
    n, b, d, k = 300, 4, 6, 20
    data, q, w = _exact_inputs(5, n, b, d, dup=1, signed=False)
    data[np.arange(n) % 37 != 5] = np.inf  # 8 finite rows, in both tiles
    dists = ref.wl1_scan(*(torch.from_numpy(x) for x in (data, q, w)))
    _, got = _schedule_topk(dists, k, 132)
    want = ref.wl1_scan_topk(*(torch.from_numpy(x) for x in (data, q, w)), k)
    _assert_bits(got, want)
    jd, ji = wl1_scan_topk_chunked(jnp.asarray(data), jnp.asarray(q), jnp.asarray(w), k, chunk=64)
    _assert_bits(got, (torch.from_numpy(np.array(jd)), torch.from_numpy(np.array(ji))))
    finite = int(np.isfinite(data).all(axis=1).sum())
    assert finite < k and torch.all(got[1][:, finite:] == -1)
    assert torch.all(torch.isinf(got[0][:, finite:]))


def _bitonic32(keys):
    """warp_sort32's network and take rule on 32 (dist, id) keys."""
    x = list(keys)
    size = 2
    while size <= 32:
        stride = size // 2
        while stride:
            y = list(x)
            for lane in range(32):
                other = x[lane ^ stride]
                up = (lane & size) == 0
                low = (lane & stride) == 0
                if (other < x[lane]) if low == up else (x[lane] < other):
                    y[lane] = other
            x = y
            stride //= 2
        size *= 2
    return x


@pytest.mark.parametrize("cnt", [0, 1, 7, 31, 32])
def test_bitonic_network_sorts_a_buffer(cnt):
    rs = np.random.default_rng(cnt)
    dv = rs.integers(0, 6, cnt).astype(np.float32) / 2  # many equal distances
    keys = [(float(v), int(i)) for v, i in zip(dv, rs.permutation(1000)[:cnt])]
    keys += [(INF, EMPTY)] * (32 - cnt)
    assert _bitonic32(keys) == sorted(keys)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 65536, 262144, 10**6])
@pytest.mark.parametrize("b", [1, 64, 65, 1024, 5000])
@pytest.mark.parametrize("k", [1, 10, K_MAX])
def test_scan_splits(n, b, k):
    sm = 132
    S = scan_splits(n, b, k, sm)
    tiles = -(-n // TILE_ROWS)
    qtiles = -(-b // BLOCK_QUERIES)
    per = -(-tiles // S)
    assert 1 <= S <= tiles
    assert (S - 1) * per < tiles  # no empty split
    assert S * per >= tiles  # every tile in a split
    if S > 1:
        assert qtiles * S <= BLOCKS_PER_SM * sm  # one wave
        assert S * k <= MERGE_ENTRIES  # the merge block stages every list
    cap = min(BLOCKS_PER_SM * sm // qtiles, tiles, MERGE_ENTRIES // k)
    assert S == -(-tiles // -(-tiles // max(1, cap)))  # the most the caps allow, trimmed


def test_scan_splits_at_the_recorded_shapes():
    sm = 132
    assert scan_splits(262144, 1024, 10, sm) == 16  # service: 256 blocks of 64 tiles
    assert scan_splits(262144, 64, 10, sm) == 256  # main: 4 tiles each
    assert scan_splits(65536, 64, 10, sm) == 256  # recorded: one tile each
    assert scan_splits(0, 5, 10, sm) == 1 and scan_splits(100, 0, 10, sm) == 1


def _project_tiled(levels, tiled, H, weights=None):
    """ref.alsh_project read through the kernel's table layout: hash h at
    tiled[h // 64, i, m, h % 64], levels clamped to {0..M} as the kernel
    clamps them; the picked values summed in ref.alsh_project's layout."""
    n, d = levels.shape
    groups, _, m1, hb = tiled.shape
    lv = levels.long().clamp(0, m1 - 1)
    picked = tiled[:, torch.arange(d)[None, :], lv, :]  # (G, n, d, 64)
    picked = picked.permute(0, 3, 1, 2).reshape(groups * hb, n, d)[:H].contiguous()
    if weights is not None:
        picked = picked * weights[None]
    return picked.sum(dim=-1).T


@pytest.mark.parametrize("H,d,M", [(1, 1, 1), (24, 13, 8), (64, 7, 32), (130, 20, 100)])
def test_tiled_tables_round_trip_and_project(H, d, M):
    """tile_folded pads the hashes to groups of 64 with zeros and puts the
    hash innermost; untile_folded takes it back; the projection read
    through it equals the plain projection bit for bit and the JAX
    reference within f32 rounding."""
    rs = np.random.default_rng(H + d + M)
    n = 37
    folded = torch.from_numpy(rs.normal(size=(H, d, M + 1)).astype(np.float32))
    levels = torch.from_numpy(rs.integers(0, M + 1, (n, d), dtype=np.int32))
    w = torch.from_numpy(rs.normal(size=(n, d)).astype(np.float32))
    tiled = tile_folded(folded)
    G = -(-H // HASH_GROUP)
    assert tuple(tiled.shape) == (G, d, M + 1, HASH_GROUP) and tiled.is_contiguous()
    assert torch.equal(untile_folded(tiled, H), folded)
    h = rs.integers(0, H)
    assert torch.equal(tiled[h // HASH_GROUP, :, :, h % HASH_GROUP], folded[h])
    assert torch.all(tiled[-1, ..., H - (G - 1) * HASH_GROUP:] == 0)  # the padded hashes
    for weights in (None, w):
        got = _project_tiled(levels, tiled, H, weights)
        _assert_bits((got, got), (ref.alsh_project(levels, folded, weights),) * 2)
        want = jref.alsh_project(jnp.asarray(levels.numpy()), jnp.asarray(folded.numpy()),
                                 None if weights is None else jnp.asarray(weights.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # levels outside {0..M} are clamped, as the kernel clamps them
    wild = levels.clone()
    wild[0, 0], wild[1, 0] = -3, M + 7
    clamped = wild.clamp(0, M)
    assert torch.equal(_project_tiled(wild, tiled, H), ref.alsh_project(clamped, folded))
    # the CPU dispatch ignores a tiled table and runs the plain version
    assert torch.equal(ops.alsh_project(levels, folded, w, tiled=tiled),
                       ref.alsh_project(levels, folded, w))
