"""The gathers' split-and-merge schedule on the CPU: the invariant it rests
on, held with the plain version's own arithmetic for every stored type the
kernels take, and the host functions that pick the schedule
(``repro_torch.kernels.gather_rerank.gather_splits`` and
``gather_schedule``).

The kernels cut each query's slots into contiguous splits, deal each
split's 32-slot groups to its warps in turn, keep the k smallest (dist,
slot) pairs of every warp and merge them, then the splits. The answer must
be the whole block's top-k bit for bit: a row's distance does not depend on
where it is computed, and merging by (dist, slot) — or, for contiguous
splits, stably in split order — keeps the earlier slot on equal distance.
The cases: f32 rows, bf16 rows, int8 rows with their decode scales (the
exact pass), int8 rows with the proxy query (the screen pass) and int8 rows
over two segments (ids across ``[data; delta]``); the whole top-k is
``ref.gather_rerank_topk`` or, for two segments,
``ref.gather_rerank_topk_segmented``. The warp reductions that give each
row its distance are replayed lane by lane in float32 against the
butterfly they must equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_rerank import gather_rerank_topk_pallas_blocked
from repro_torch import quant
from repro_torch.kernels import ref
from repro_torch.kernels.gather_rerank import (
    MIN_GROUPS_PER_WARP,
    SPLIT_WARPS,
    WARP_SCHEDULE,
    gather_schedule,
    gather_splits,
)

SM_COUNT = 132  # an H100 SXM
CASES = ["f32", "bf16", "int8-scaled", "int8-proxy", "int8-two-seg"]
MIN_BLOCKS = [1, 2, 3, 4]  # blocks per SM an instantiation's registers may allow


def _ranges(P: int, S: int) -> list[tuple[int, int]]:
    """The kernel's cut (csrc/gather_rerank.cuh, launch_split): ceil(groups / S)
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


class Stored:
    """One case's table as the kernel takes it: ``data`` in its stored dtype
    (with ``delta`` for two segments), the decode ``scales``, the ids and
    the query and weights the kernel is given."""

    def __init__(self, case: str, seed: int, b: int, P: int, k: int):
        x, self.ids, q, w, self.k = _block(seed, b, P, k)
        self.delta = self.scales = None
        if case == "bf16":
            x = x.to(torch.bfloat16)
        elif case.startswith("int8"):
            codec = quant.get_codec("int8")
            x, scales = codec.encode(x)
            if case == "int8-proxy":  # the screen pass: integer levels and w·s, no scales
                q, w = quant.proxy_query(q, w, x.dtype, scales)
            else:
                self.scales = scales
            if case == "int8-two-seg":  # the last quarter of the rows is the delta
                cut = x.shape[0] * 3 // 4
                x, self.delta = x[:cut].contiguous(), x[cut:].contiguous()
        self.data, self.q, self.w = x, q, w

    def topk(self, ids, q=None, w=None):
        """The plain version over ``ids`` (all queries, or one query's)."""
        q = self.q if q is None else q
        w = self.w if w is None else w
        if self.delta is None:
            return ref.gather_rerank_topk(self.data, ids, q, w, self.k, scales=self.scales)
        return ref.gather_rerank_topk_segmented(self.data, self.delta, ids, q, w, self.k,
                                                scales=self.scales)

    def rows(self):
        """The virtual table the ids address."""
        return self.data if self.delta is None else torch.cat([self.data, self.delta])


def _merge_in_split_order(parts, k):
    """The splits' top-k lists merged stably, the earlier split first on equal
    distance."""
    cat_d = torch.cat([p[0] for p in parts], dim=1)
    cat_i = torch.cat([p[1] for p in parts], dim=1)
    sd, order = torch.sort(cat_d, dim=1, stable=True)
    return sd[:, :k], torch.gather(cat_i, 1, order[:, :k])


def _assert_bits(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 10, 20, 40])
@pytest.mark.parametrize("S", [1, 2, 3, 7])
def test_split_topk_merged_in_split_order_is_the_whole_topk(S, k, case):
    t = Stored(case, S * 100 + k, b=4, P=7 * 32 * 3 + 5, k=k)  # P % 32 == 5
    P = t.ids.shape[1]
    whole = t.topk(t.ids)
    parts = [t.topk(t.ids[:, a:z].contiguous()) for a, z in _ranges(P, S)]
    _assert_bits(_merge_in_split_order(parts, k), whole)
    assert torch.all(whole[1][0] == -1)  # the all-sentinel query
    if k > 1:  # equal distances within the top-k: the duplicates are in play
        assert bool((whole[0][:, 1:] == whole[0][:, :-1]).any())


def _slot_topk(t: Stored, ids, q, w, slots):
    """The plain version of one query over the given slots, as (dist, slot):
    the query's candidate rows become a table indexed by slot."""
    rows = t.rows()
    n = rows.shape[0]
    valid = (ids >= 0) & (ids < n)
    table = rows[ids.clamp(0, n - 1).long()]  # (P, d), stored dtype
    slot_ids = torch.where(valid, torch.arange(ids.shape[0], dtype=torch.int32),
                           torch.full_like(ids, ids.shape[0]))
    return ref.gather_rerank_topk(table, slot_ids[slots][None], q[None], w[None], t.k,
                                  scales=t.scales)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [1, 10, 20, 40])
def test_warp_lists_merged_by_slot_are_the_whole_topk(k, case):
    """The kernel's full schedule: per split, warp j of SPLIT_WARPS keeps the
    k smallest (dist, slot) of the groups j, j + SPLIT_WARPS, ...; the lists
    of all warps of all splits merged by (dist, slot) give the whole top-k
    as (dist, id), bit for bit. S = 0 stands for the one-warp schedule: one
    list over every slot in order."""
    t = Stored(case, 7 + k, b=3, P=5 * 32 * SPLIT_WARPS + 17, k=k)
    b, P = t.ids.shape
    whole = t.topk(t.ids)
    for S in (WARP_SCHEDULE, 1, 3):
        for i in range(b):
            lists = []
            if S == WARP_SCHEDULE:
                lists.append(_slot_topk(t, t.ids[i], t.q[i], t.w[i], torch.arange(P)))
            for a, z in _ranges(P, S) if S else ():
                for warp in range(SPLIT_WARPS):
                    slots = torch.tensor([c + j for c in range(a + 32 * warp, z, 32 * SPLIT_WARPS)
                                          for j in range(32) if c + j < z], dtype=torch.long)
                    lists.append(_slot_topk(t, t.ids[i], t.q[i], t.w[i], slots))
            dist = torch.cat([x[0][0] for x in lists])
            slot = torch.cat([x[1][0] for x in lists]).long()
            real = slot >= 0
            key = sorted(zip(dist[real].tolist(), slot[real].tolist()))[:k]
            got_d = torch.full((k,), float("inf"))
            got_i = torch.full((k,), -1, dtype=torch.int32)
            for j, (dv, s) in enumerate(key):
                got_d[j], got_i[j] = dv, t.ids[i, s]
            _assert_bits((got_d, got_i), (whole[0][i], whole[1][i]))


def test_split_replay_of_the_int8_two_segment_pass_matches_the_pallas_kernel():
    """The split schedule's answer over int8 rows in two segments (decode
    scales, k = 20) against the reference's Pallas kernel in interpret mode:
    ids equal, distances within rtol/atol 1e-5. Distinct rows, so no tie
    can order the two differently."""
    rs = np.random.default_rng(17)
    n_main, cap, b, P, d, k = 300, 80, 3, 2 * 32 * SPLIT_WARPS + 9, 24, 20
    x = rs.uniform(-1, 1, (n_main + cap, d)).astype(np.float32)
    ids = rs.integers(-3, n_main + cap + 40, (b, P)).astype(np.int32)
    ids[0, : P // 3] = rs.integers(n_main, n_main + cap, P // 3)  # delta rows ahead
    q = rs.uniform(-1, 1, (b, d)).astype(np.float32)
    w = np.abs(rs.normal(size=(b, d))).astype(np.float32)
    codec = quant.get_codec("int8")
    main, scales = codec.encode(torch.from_numpy(x[:n_main]))
    delta = codec.encode_rows(torch.from_numpy(x[n_main:]), scales)
    tids, tq, tw = torch.from_numpy(ids), torch.from_numpy(q), torch.from_numpy(w)
    whole = ref.gather_rerank_topk_segmented(main, delta, tids, tq, tw, k, scales=scales)
    parts = [ref.gather_rerank_topk_segmented(main, delta, tids[:, a:z].contiguous(), tq, tw,
                                              k, scales=scales) for a, z in _ranges(P, 3)]
    _assert_bits(_merge_in_split_order(parts, k), whole)
    pd, pi = gather_rerank_topk_pallas_blocked(
        jnp.asarray(main.numpy()), jnp.asarray(ids), jnp.asarray(q), jnp.asarray(w), k,
        delta=jnp.asarray(delta.numpy()), scales=jnp.asarray(scales.numpy()), interpret=True)
    np.testing.assert_allclose(whole[0].numpy(), np.asarray(pd), rtol=1e-5, atol=1e-5)
    assert np.array_equal(whole[1].numpy(), np.asarray(pi))
    assert bool((whole[1][0] >= n_main).any())  # delta rows reach the top-k


# The kernels' warp reductions (csrc/gather_rerank.cuh), replayed lane by
# lane in float32: a shuffle reads the partner lane's value, and every add
# rounds as on the card.
LANES = np.arange(32)


def _butterfly(x):
    """One row's sum: the xor-butterfly over the 32 lanes (every lane ends
    with it; lane 0's)."""
    v = x.astype(np.float32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[LANES ^ off]
    return v[0]


def _reduce_half(x, bit):
    """reduce_half: x is (2N, 32); lanes with `bit` clear keep the first
    half, the others the second, each adding the partner's copy."""
    n = x.shape[0] // 2
    upper = (LANES & bit) != 0
    keep = np.where(upper, x[n:], x[:n])
    send = np.where(upper, x[:n], x[n:])
    return keep + send[:, LANES ^ bit]


def _reduce_rows(part):
    """reduce_rows over (8, 32) partials: lane l ends with row (l >> 2) & 7."""
    a = _reduce_half(part, 16)
    b = _reduce_half(a, 8)
    s = _reduce_half(b, 4)[0]
    for off in (2, 1):
        s = s + s[LANES ^ off]
    return s


def _reduce_packed(p):
    """reduce_packed over (2, 32) chains of two rows (lanes 0-15 row 0, 16-31
    row 1; lane m holds virtual lanes 2m and 2m + 1 of its row)."""
    s = _reduce_half(p, 8)[0]
    for off in (4, 2, 1, 8):
        s = s + s[LANES ^ off]
    return s


@pytest.mark.parametrize("seed", range(6))
def test_warp_reductions_add_the_butterflys_pairs(seed):
    """Both reductions give every row the per-row butterfly's bits: the
    transposed one over 8 rows of 32 lane partials, and the PACKED one over
    the chains of virtual lanes v = 2m + t. Partials span many binades, so a
    different tree would round differently."""
    rs = np.random.default_rng(seed)
    rows = (rs.standard_normal((8, 32)) * 10.0 ** rs.uniform(-4, 4, (8, 32))).astype(np.float32)
    want = np.array([_butterfly(r) for r in rows], np.float32)
    got = _reduce_rows(rows)
    assert np.array_equal(got.view(np.int32), want[(LANES >> 2) & 7].view(np.int32))
    for pair in range(4):  # two rows per load
        two = rows[2 * pair: 2 * pair + 2]
        chains = np.stack([two[LANES // 16, 2 * (LANES % 16) + t] for t in (0, 1)])
        got = _reduce_packed(chains)
        assert np.array_equal(got.view(np.int32), want[2 * pair + LANES // 16].view(np.int32))
    # the trees do differ from a plain left-to-right sum on this data
    assert any(np.float32(sum(np.float32(v) for v in r)) != w for r, w in zip(rows, want))


@pytest.mark.parametrize("min_blocks", MIN_BLOCKS)
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
def test_gather_splits(b, P, want, min_blocks):
    S = gather_splits(b, P, SM_COUNT, min_blocks)
    groups = -(-P // 32)
    assert (S == 1) == (want == "one")
    assert 1 <= S <= max(1, groups)
    assert all(a < z for a, z in _ranges(P, S)) or P == 0  # no empty split
    assert _ranges(P, S)[-1][1] == P
    if S > 1:  # a few blocks per SM in one wave, and enough groups per warp
        assert b * S <= min_blocks * SM_COUNT
        assert -(-groups // S) >= SPLIT_WARPS * MIN_GROUPS_PER_WARP


@pytest.mark.parametrize("min_blocks", MIN_BLOCKS)
@pytest.mark.parametrize(
    "b,P,want",
    [
        (1024, 20, "warp"),  # the exact pass over the screen's survivors
        (1024, 224, "warp"),  # 7 groups: one short of a split block's warps
        (1024, 225, "one"),
        (1024, 4096, "one"),  # the service batch
        (1024, 12288, "one"),  # the stream batch
        (64, 270336, "many"),  # exact mode of a mutable index
        (0, 4096, "one"),  # no query
        (0, 20, "warp"),
        (5, 0, "warp"),  # no slot
    ],
)
def test_gather_schedule(b, P, want, min_blocks):
    """One warp per query below SPLIT_WARPS groups of 32 slots, else the
    split schedule with gather_splits' S, for every blocks-per-SM count."""
    S = gather_schedule(b, P, SM_COUNT, min_blocks)
    if want == "warp":
        assert S == WARP_SCHEDULE
    else:
        assert S == gather_splits(b, P, SM_COUNT, min_blocks) >= 1
        assert (S == 1) == (want == "one")
