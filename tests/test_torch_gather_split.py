"""The f32 gathers' split-and-merge schedule on the CPU: the invariant it
rests on, held with the plain version's own arithmetic, and the host split
function (``repro_torch.kernels.gather_rerank.gather_splits``).

The kernel cuts each query's slots into contiguous splits, deals each
split's 32-slot groups to its warps in turn, keeps the k smallest (dist,
slot) pairs of every warp and merges them, then the splits. The answer must
be the whole block's top-k bit for bit: a row's distance does not depend on
where it is computed, and merging by (dist, slot) — or, for contiguous
splits, stably in split order — keeps the earlier slot on equal distance.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.gather_rerank import (
    MIN_GROUPS_PER_WARP,
    SPLIT_MIN_BLOCKS,
    SPLIT_WARPS,
    gather_splits,
)

SM_COUNT = 132  # an H100 SXM


def _ranges(P: int, S: int) -> list[tuple[int, int]]:
    """The kernel's cut (csrc/gather_rerank.cu, launch_split): ceil(groups / S)
    whole 32-slot groups per split, the last one ragged."""
    groups = -(-P // 32)
    per = -(-groups // S) * 32
    return [(min(P, s * per), min(P, (s + 1) * per)) for s in range(S)]


def _block(seed: int, b: int, P: int, k: int):
    """Rows with exact duplicates (each row 4 times, so equal distances under
    distinct ids), ids that put copies on both sides of every split boundary
    and repeat some ids, ~20% invalid slots (negative or >= n), a query whose
    slots are all sentinels and a query whose last 40% are sentinels (the
    dedupe stage's packing, so whole splits hold no valid id)."""
    rs = np.random.default_rng(seed)
    d, m = 24, 60
    base = rs.normal(size=(m, d)).astype(np.float32)
    data = np.concatenate([base] * 4)  # row r and r + m, r + 2m, r + 3m tie exactly
    n = data.shape[0]
    q = rs.normal(size=(b, d)).astype(np.float32)
    w = np.abs(rs.normal(size=(b, d))).astype(np.float32)
    ids = rs.integers(-3, n + n // 4, (b, P)).astype(np.int32)
    ids[0] = n
    if b > 2:
        ids[2, int(0.6 * P):] = n
    return tuple(torch.from_numpy(x) for x in (data, ids, q, w)) + (k,)


def _merge_in_split_order(parts, k):
    """The splits' top-k lists merged stably, the earlier split first on equal
    distance."""
    cat_d = torch.cat([p[0] for p in parts], dim=1)
    cat_i = torch.cat([p[1] for p in parts], dim=1)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], torch.gather(cat_i, 1, order[:, :k])


def _assert_bits(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [1, 10, 40])
@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_split_topk_merged_in_split_order_is_the_whole_topk(S, k):
    data, ids, q, w, k = _block(S * 100 + k, b=4, P=7 * 32 * 3 + 5, k=k)  # P % 32 == 5
    P = ids.shape[1]
    whole = ref.gather_rerank_topk(data, ids, q, w, k)
    parts = [ref.gather_rerank_topk(data, ids[:, a:z].contiguous(), q, w, k)
             for a, z in _ranges(P, S)]
    _assert_bits(_merge_in_split_order(parts, k), whole)
    assert torch.all(whole[1][0] == -1)  # the all-sentinel query
    if k > 1:  # equal distances within the top-k: the duplicates are in play
        assert bool((whole[0][:, 1:] == whole[0][:, :-1]).any())


def _slot_topk(data, ids, q, w, slots, k):
    """ref.gather_rerank_topk of one query over the given slots, as (dist,
    slot): the query's candidate rows become a table indexed by slot."""
    n = data.shape[0]
    valid = (ids >= 0) & (ids < n)
    table = data[ids.clamp(0, n - 1).long()]  # (P, d)
    slot_ids = torch.where(valid, torch.arange(ids.shape[0], dtype=torch.int32),
                           torch.full_like(ids, ids.shape[0]))
    return ref.gather_rerank_topk(table, slot_ids[slots][None], q[None], w[None], k)


@pytest.mark.parametrize("k", [1, 10, 40])
def test_warp_lists_merged_by_slot_are_the_whole_topk(k):
    """The kernel's full schedule: per split, warp j of SPLIT_WARPS keeps the
    k smallest (dist, slot) of the groups j, j + SPLIT_WARPS, ...; the lists
    of all warps of all splits merged by (dist, slot) give the whole top-k
    as (dist, id), bit for bit."""
    data, ids, q, w, k = _block(7 + k, b=3, P=5 * 32 * SPLIT_WARPS + 17, k=k)
    b, P = ids.shape
    whole = ref.gather_rerank_topk(data, ids, q, w, k)
    for S in (1, 3):
        for i in range(b):
            lists = []
            for a, z in _ranges(P, S):
                for warp in range(SPLIT_WARPS):
                    slots = torch.tensor([c + t for c in range(a + 32 * warp, z, 32 * SPLIT_WARPS)
                                          for t in range(32) if c + t < z], dtype=torch.long)
                    lists.append(_slot_topk(data, ids[i], q[i], w[i], slots, k))
            dist = torch.cat([x[0][0] for x in lists])
            slot = torch.cat([x[1][0] for x in lists]).long()
            real = slot >= 0
            key = sorted(zip(dist[real].tolist(), slot[real].tolist()))[:k]
            got_d = torch.full((k,), float("inf"))
            got_i = torch.full((k,), -1, dtype=torch.int32)
            for j, (dv, s) in enumerate(key):
                got_d[j], got_i[j] = dv, ids[i, s]
            _assert_bits((got_d, got_i), (whole[0][i], whole[1][i]))


@pytest.mark.parametrize(
    "b,P,want",
    [
        (1024, 4096, "one"),  # the service batch
        (1024, 12288, "one"),  # the stream batch
        (1024, 1034, "one"),  # a streamed early-exit merge
        (64, 270336, "many"),  # exact mode of a mutable index: every live id
        (2, 20000, "many"),
        (300, 128, "one"),
        (1, 1, "one"),
        (7, 0, "one"),
    ],
)
def test_gather_splits(b, P, want):
    S = gather_splits(b, P, SM_COUNT)
    groups = -(-P // 32)
    assert (S == 1) == (want == "one")
    assert 1 <= S <= max(1, groups)
    assert all(a < z for a, z in _ranges(P, S)) or P == 0  # no empty split
    assert _ranges(P, S)[-1][1] == P
    if S > 1:  # a few blocks per SM in one wave, and enough groups per warp
        assert b * S <= SPLIT_MIN_BLOCKS * SM_COUNT
        assert -(-groups // S) >= SPLIT_WARPS * MIN_GROUPS_PER_WARP
