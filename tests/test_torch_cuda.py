"""The hand-written CUDA kernels against their plain versions, and the slice
on the card. Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip
without a card. Run on the GPU machine with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the kernels and the plain versions sum in different orders, so
values agree to f32 rounding (rtol/atol 1e-5 for distances, 1e-4 absolute
for projections of magnitude ~10); ids agree except where the row returned is
a genuine tie (its recomputed distance matches the plain version's slot).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

SCAN_TOPK_SHAPES = [
    (1, 1, 1, 1),
    (33, 3, 7, 5),
    (128, 8, 256, 128),
    (129, 9, 257, 10),
    (300, 5, 16, 3),
    (4, 2, 2, 8),
    (5000, 70, 128, 10),  # several splits and query tiles
]
GATHER_SHAPES = [
    (50, 3, 17, 7, 5),
    (200, 2, 64, 128, 10),
    (8, 2, 40, 5, 3),
    (10, 2, 16, 300, 4),
    (5, 1, 1, 1, 1),
    (3000, 37, 700, 128, 10),
]
PROJECT_SHAPES = [
    (1, 1, 1, 1),
    (37, 13, 24, 8),
    (300, 128, 384, 32),
    (129, 40, 33, 64),
    (20000, 24, 128, 16),  # 256-row tiles, d not a multiple of the chunk
    (300, 20, 64, 100),  # M+1 = 101: 8-coordinate chunks
    (20000, 24, 128, 100),  # 8-coordinate chunks on 256-row tiles
    (2000, 16, 40, 200),  # M+1 = 201: 4-coordinate chunks
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _check_topk(got, want, data, q, w):
    gd, gi = (t.cpu() for t in got)
    wd, wi = (t.cpu() for t in want)
    torch.testing.assert_close(gd, wd, rtol=1e-5, atol=1e-5)
    assert torch.equal(gi == -1, ~torch.isfinite(gd))
    assert ref.unexplained_id_mismatches(gi, wd, wi, data.cpu(), q.cpu(), w.cpu(),
                                         rtol=1e-5, atol=1e-5) == 0


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,d,H,M", PROJECT_SHAPES)
def test_alsh_project_kernel_matches_plain(dev, n, d, H, M, weighted):
    rs = np.random.default_rng(n + d + H + M)
    levels = _t(rs.integers(0, M + 1, (n, d), dtype=np.int32), dev)
    folded = _t(rs.normal(size=(H, d, M + 1)).astype(np.float32), dev)
    w = _t(rs.normal(size=(n, d)).astype(np.float32), dev) if weighted else None
    got = ops.alsh_project(levels, folded, w)
    want = ops.alsh_project(levels, folded, w, force="plain")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n,b,d,k", SCAN_TOPK_SHAPES)
def test_scan_topk_kernel_matches_plain(dev, n, b, d, k):
    rs = np.random.default_rng(n * 31 + b * 7 + d + k)
    data = _t(rs.normal(size=(n, d)).astype(np.float32), dev)
    q = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    got = ops.wl1_scan_topk(data, q, w, k)
    torch.cuda.synchronize()
    _check_topk(got, ops.wl1_scan_topk(data, q, w, k, force="plain"), data, q, w)


def test_scan_topk_kernel_ties_go_to_lower_id(dev):
    rs = np.random.default_rng(3)
    base = rs.normal(size=(700, 16)).astype(np.float32)
    data = _t(np.concatenate([base] * 4), dev)  # every distance 4 times, across splits
    q = _t(rs.normal(size=(9, 16)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(9, 16))).astype(np.float32), dev)
    got = ops.wl1_scan_topk(data, q, w, 12)
    _check_topk(got, ops.wl1_scan_topk(data, q, w, 12, force="plain"), data, q, w)
    gd, gi = (t.cpu() for t in got)
    tie = gd[:, 1:] == gd[:, :-1]  # exact ties: copies of one row
    assert tie.any() and torch.all(gi[:, 1:][tie] > gi[:, :-1][tie])


@pytest.mark.parametrize("n,b,P,d,k", GATHER_SHAPES)
def test_gather_rerank_kernel_matches_plain(dev, n, b, P, d, k):
    rs = np.random.default_rng(n + P * 13 + d + k)
    data = _t(rs.normal(size=(n, d)).astype(np.float32), dev)
    q = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    ids = _t(np.minimum(rs.integers(0, n + max(2, n // 3), (b, P)), n).astype(np.int32), dev)
    got = ops.gather_rerank_topk(data, ids, q, w, k)
    torch.cuda.synchronize()
    _check_topk(got, ops.gather_rerank_topk(data, ids, q, w, k, force="plain"), data, q, w)


def test_gather_rerank_kernel_packed_and_all_invalid(dev):
    from repro_torch.core.index import _dedupe_candidates

    rs = np.random.default_rng(4)
    n, b, P, d, k = 500, 6, 256, 128, 10
    data = _t(rs.normal(size=(n, d)).astype(np.float32), dev)
    q = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(b, d))).astype(np.float32), dev)
    cand = _t(rs.integers(0, n + 50, (b, P)).astype(np.int32), dev)
    cand[0] = n  # every slot a sentinel
    packed, _ = _dedupe_candidates(cand, n)
    got = ops.gather_rerank_topk(data, packed, q, w, k)
    _check_topk(got, ops.gather_rerank_topk(data, packed, q, w, k, force="plain"), data, q, w)
    assert torch.all(got[1][0] == -1) and torch.all(torch.isinf(got[0][0]))


def _quantized(x, case, dev):
    """(payload, scales) of rows ``x`` for a blocked-kernel case."""
    from repro_torch import quant

    codec = {"int8": "int8", "int8-scaled": "int8", "bf16": "bf16"}[case]
    payload, scales = quant.get_codec(codec).encode(x)
    return payload.contiguous(), (scales if case == "int8-scaled" else None)


@pytest.mark.parametrize("case", ["int8", "int8-scaled", "bf16"])
@pytest.mark.parametrize("n,b,P,d,k", GATHER_SHAPES)
def test_gather_rerank_blocked_kernel_matches_plain(dev, n, b, P, d, k, case):
    """The quantized kernel against its plain version, and bit for bit
    against the f32 kernel over the decoded table (same decode, same sum
    order)."""
    from repro_torch import quant
    from repro_torch.kernels._build import GATHER_RERANK_BLOCKED

    rs = np.random.default_rng(n + P * 13 + d + k + len(case))
    x = _t(rs.uniform(-1, 1, (n, d)).astype(np.float32), dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    ids = _t(np.minimum(rs.integers(0, n + max(2, n // 3), (b, P)), n).astype(np.int32), dev)
    payload, scales = _quantized(x, case, dev)
    if case == "int8":  # the screen pass: integer levels and w·s, no scales
        q, w = quant.proxy_query(q, w, payload.dtype, quant.get_codec("int8").fit_scales(x))
    before = GATHER_RERANK_BLOCKED.launches
    got = ops.gather_rerank_topk(payload, ids, q, w, k, scales=scales)
    torch.cuda.synchronize()
    assert GATHER_RERANK_BLOCKED.launches == before + 1
    decoded = quant.decode_table(payload, scales)
    _check_topk(got, ops.gather_rerank_topk(payload, ids, q, w, k, scales=scales, force="plain"),
                decoded, q, w)
    f32 = ops.gather_rerank_topk(decoded.contiguous(), ids, q, w, k)
    assert torch.equal(got[0], f32[0]) and torch.equal(got[1], f32[1])


@pytest.mark.parametrize("case", ["int8", "int8-scaled", "bf16"])
def test_gather_rerank_blocked_kernel_packed_and_all_invalid(dev, case):
    from repro_torch.core.index import _dedupe_candidates

    rs = np.random.default_rng(6)
    n, b, P, d, k = 500, 6, 256, 128, 20
    x = _t(rs.uniform(0, 1, (n, d)).astype(np.float32), dev)
    q = _t(rs.uniform(0, 1, (b, d)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(b, d))).astype(np.float32), dev)
    cand = _t(rs.integers(0, n + 50, (b, P)).astype(np.int32), dev)
    cand[0] = n  # every slot a sentinel
    packed, _ = _dedupe_candidates(cand, n)
    payload, scales = _quantized(x, case, dev)
    from repro_torch import quant

    got = ops.gather_rerank_topk(payload, packed, q, w, k, scales=scales)
    want = ops.gather_rerank_topk(payload, packed, q, w, k, scales=scales, force="plain")
    decoded = quant.decode_table(payload, scales)
    _check_topk(got, want, decoded, q, w)
    assert torch.all(got[1][0] == -1) and torch.all(torch.isinf(got[0][0]))


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_quantized_engine_on_the_card_matches_the_cpu_path(dev, storage):
    """Screened (α=2) and unscreened queries of one quantized index state on
    the card and on the CPU; n_candidates equal the f32 index's."""
    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.kernels._build import GATHER_RERANK_BLOCKED

    rs = np.random.default_rng(7)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, max_candidates=64, storage=storage,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    data = rs.uniform(0, 1, (8192, 32)).astype(np.float32)
    q = rs.uniform(0, 1, (64, 32)).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 32))) + 0.1).astype(np.float32)
    gpu = tapi.Index.build(11, data, cfg)
    f32 = tapi.Index.build(11, data, tapi.IndexConfig(
        d=32, M=32, K=8, L=16, max_candidates=64, space=tapi.BoundedSpace(0.0, 1.0, 32.0)))
    cpu = tapi.Index(state=gpu.state.to("cpu"), config=cfg)
    decoded = quant.decode_table(cpu.state.data, cpu.state.scales)
    for alpha, launches in ((0.0, 1), (2.0, 2)):
        spec = tapi.QuerySpec(k=10, screen_alpha=alpha)
        before = GATHER_RERANK_BLOCKED.launches
        g = gpu.query(q, w, spec)
        assert GATHER_RERANK_BLOCKED.launches == before + launches
        c = cpu.query(q, w, spec)
        ref_f32 = f32.query(q, w, tapi.QuerySpec(k=10))
        assert torch.equal(g.n_candidates, ref_f32.n_candidates)
        rows = g.n_candidates.cpu() == c.n_candidates
        assert rows.float().mean() >= 0.9
        _check_topk((g.dists.cpu()[rows], g.ids.cpu()[rows]), (c.dists[rows], c.ids[rows]),
                    decoded, torch.from_numpy(q)[rows], torch.from_numpy(w)[rows])


@pytest.mark.parametrize("family", ["theta", "l2"])
def test_engine_on_the_card_matches_the_cpu_path(dev, family):
    """The same index state queried on the card (kernels) and on the CPU
    (plain versions): exact mode agrees up to near-ties; probe mode agrees
    except where a projection within rounding of a bucket edge flips a key."""
    import repro_torch.api as tapi

    rs = np.random.default_rng(5)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, family=family, W=32.0, max_candidates=64,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    data = rs.uniform(0, 1, (8192, 32)).astype(np.float32)
    q = rs.uniform(0, 1, (64, 32)).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 32))) + 0.1).astype(np.float32)
    gpu = tapi.Index.build(11, data, cfg)
    assert gpu.device.type == "cuda"
    cpu = tapi.Index(state=gpu.state.to("cpu"), config=cfg)
    ex_g = gpu.query(q, w, tapi.QuerySpec(k=10, mode="exact"))
    ex_c = cpu.query(q, w, tapi.QuerySpec(k=10, mode="exact"))
    _check_topk((ex_g.dists, ex_g.ids), (ex_c.dists, ex_c.ids), cpu.state.data,
                torch.from_numpy(q), torch.from_numpy(w))
    pr_g = gpu.query(q, w, tapi.QuerySpec(k=10))
    pr_c = cpu.query(q, w, tapi.QuerySpec(k=10))
    same = (pr_g.n_candidates.cpu() == pr_c.n_candidates).float().mean()
    assert same >= 0.9
    assert torch.all(pr_g.dists.cpu() >= ex_c.dists - 1e-4)


def test_multiprobe_on_the_card_sees_a_superset_of_probe(dev):
    import repro_torch.api as tapi

    rs = np.random.default_rng(8)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, max_candidates=64,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    idx = tapi.Index.build(12, rs.uniform(0, 1, (8192, 32)).astype(np.float32), cfg)
    q = rs.uniform(0, 1, (64, 32)).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 32))) + 0.1).astype(np.float32)
    pr = idx.query(q, w, tapi.QuerySpec(k=10))
    mp = idx.query(q, w, tapi.QuerySpec(k=10, mode="multiprobe", n_probes=8, max_flips=3))
    assert torch.all(mp.n_candidates >= pr.n_candidates)
    assert torch.all(mp.dists <= pr.dists + 1e-6)


# (K, max_flips, n_probes): the register lists of 1 to 32 slots and the
# device-memory list (P > 32), P clamped to the subset count (299 at K=12, 3
# flips; 32 at K=5, 5 flips), no flips, one probe
MULTIPROBE_KEY_CASES = [(12, 3, 8), (12, 3, 299), (12, 3, 400), (31, 2, 40), (5, 5, 32),
                        (12, 0, 8), (12, 1, 1), (8, 2, 16), (4, 3, 3), (6, 1, 2)]


def _flip_scores(proj, keys):
    """The float64 score of the flip subset behind each (b, L, P) key: the
    |proj| summed over the bits where the key differs from the sign key."""
    K = proj.shape[-1]
    bit = np.int64(1) << np.arange(K, dtype=np.int64)
    base = ((proj >= 0).astype(np.int64) * bit).sum(-1)
    flips = keys.astype(np.int64) ^ base[..., None]
    bits = (flips[..., None] & bit) != 0  # (b, L, P, K)
    return (bits * np.abs(proj.astype(np.float64))[:, :, None, :]).sum(-1)


@pytest.mark.parametrize("K,max_flips,n_probes", MULTIPROBE_KEY_CASES)
def test_multiprobe_keys_kernel_equals_plain_on_dyadic_projections(dev, K, max_flips, n_probes):
    """Multiples of 2**-8 in [-4, 4]: every subset sum is exact in f32 and
    ties are frequent, so the keys and their tie order must be equal."""
    rs = np.random.default_rng(K * 1000 + max_flips * 100 + n_probes)
    proj = _t((rs.integers(-1024, 1025, (64, 8, K)) / 256).astype(np.float32), dev)
    got = ops.multiprobe_keys(proj, n_probes, max_flips)
    want = ops.multiprobe_keys(proj, n_probes, max_flips, force="plain")
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)


def test_multiprobe_keys_kernel_on_normal_projections(dev):
    """At the multiprobe cell's shape (b=1000, L=32, K=12, 8 probes, 3
    flips) the two versions add in different orders: a key may differ only
    where both subsets' float64 scores agree within 1e-6 relative."""
    rs = np.random.default_rng(31)
    proj = rs.normal(size=(1000, 32, 12)).astype(np.float32)
    got = ops.multiprobe_keys(_t(proj, dev), 8, 3).cpu().numpy()
    want = ops.multiprobe_keys(_t(proj, dev), 8, 3, force="plain").cpu().numpy()
    assert got.shape == want.shape == (1000, 32, 8)
    sg, sw = _flip_scores(proj, got), _flip_scores(proj, want)
    differ = got != want
    assert np.all(np.abs(sg - sw)[differ] <= 1e-6 * np.maximum(sg, sw)[differ])
    assert differ.mean() < 1e-3


def test_multiprobe_keys_kernel_counts_one_launch(dev):
    from repro_torch.kernels import _build

    before = _build.launch_counts()["multiprobe_keys"]
    ops.multiprobe_keys(torch.randn((4, 3, 12), device=dev), 8, 3)
    assert _build.launch_counts()["multiprobe_keys"] == before + 1


def test_multiprobe_query_on_the_card_builds_no_subset_table(dev, monkeypatch):
    """A multiprobe query on the card never calls ``flip_subsets``; the
    plain version, which builds that table, does."""
    import repro_torch.api as tapi
    from repro_torch.core import families

    def refuse(*args, **kwargs):
        raise AssertionError("flip_subsets called")

    rs = np.random.default_rng(9)
    cfg = tapi.IndexConfig(d=32, M=32, K=12, L=8, max_candidates=64,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    idx = tapi.Index.build(13, rs.uniform(0, 1, (4096, 32)).astype(np.float32), cfg)
    q = rs.uniform(0, 1, (32, 32)).astype(np.float32)
    w = (np.abs(rs.normal(size=(32, 32))) + 0.1).astype(np.float32)
    monkeypatch.setattr(families, "flip_subsets", refuse)
    res = idx.query(q, w, tapi.QuerySpec(k=10, mode="multiprobe", n_probes=8, max_flips=3))
    assert res.ids.shape == (32, 10)
    with pytest.raises(AssertionError, match="flip_subsets"):
        ops.multiprobe_keys(torch.randn((2, 8, 12), device=dev), 8, 3, force="plain")


def _persist_case(storage, mutable):
    """A small index on the card (n=8192, d=32), mutable ones with a filled
    delta and tombstones, and a query batch."""
    import repro_torch.api as tapi

    rs = np.random.default_rng(21)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, max_candidates=64, storage=storage,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    data = rs.uniform(0, 1, (8192, 32)).astype(np.float32)
    extra = rs.uniform(0, 1, (300, 32)).astype(np.float32)
    update = tapi.UpdateSpec(delta_capacity=512 if mutable else 0)
    idx = tapi.Index.build(13, data, cfg, update=update)
    if mutable:
        idx, ids = idx.insert(extra)
        idx = idx.delete(torch.cat([torch.arange(0, 400, 3, device="cuda"), ids[::7].long()]))
    q = np.concatenate([extra[:16], rs.uniform(0, 1, (48, 32))]).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 32))) + 0.1).astype(np.float32)
    return idx, q, w


@pytest.mark.parametrize("storage,mutable", [("f32", False), ("f32", True), ("int8", True),
                                             ("bf16", False)])
def test_save_and_load_on_the_card_answer_bit_for_bit(dev, tmp_path, storage, mutable):
    """A round trip through the disk on the card: every tensor (and the
    kernel's relayout ``tiled``) equal, and the f32, int8 and bf16 tails
    (two-segment where mutable) answer bit for bit."""
    import repro_torch.api as tapi

    idx, q, w = _persist_case(storage, mutable)
    back = tapi.Index.load(idx.save(tmp_path / "idx"))
    assert back.device.type == "cuda" and back.state.tables.tiled is not None
    assert torch.equal(back.state.tables.tiled, idx.state.tables.tiled)
    for name in ("mixers", "sorted_keys", "perm", "data", "levels"):
        assert torch.equal(getattr(back.state, name), getattr(idx.state, name)), name
    for name in ("data", "levels", "keys"):
        assert torch.equal(getattr(back.delta, name), getattr(idx.delta, name)), name
    assert torch.equal(back.tombstones, idx.tombstones) and back.delta_fill == idx.delta_fill
    alphas = (0.0,) if storage == "f32" else (0.0, 2.0)
    for spec in [tapi.QuerySpec(k=10, screen_alpha=a) for a in alphas] + [
            tapi.QuerySpec(k=10, mode="exact")]:
        a, b = idx.query(q, w, spec), back.query(q, w, spec)
        for f in ("ids", "dists", "n_candidates"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (spec, f)


@pytest.mark.parametrize("storage", ["f32", "int8", "bf16"])
def test_directory_saved_on_the_card_loads_on_the_cpu(dev, tmp_path, storage):
    """Loaded with device="cpu", the card's directory answers as the card
    does within the bar: exact mode up to near-ties, probe mode except where
    a projection within rounding of a bucket edge flips a key."""
    import repro_torch.api as tapi
    from repro_torch import quant

    idx, q, w = _persist_case(storage, mutable=True)
    cpu = tapi.Index.load(idx.save(tmp_path / "idx"), device="cpu")
    assert cpu.device.type == "cpu" and cpu.state.tables.tiled is None
    assert torch.equal(cpu.state.data.cpu(), idx.state.data.cpu())
    decoded = quant.decode_table(torch.cat([cpu.state.data, cpu.delta.data]), cpu.state.scales)
    ex_g = idx.query(q, w, tapi.QuerySpec(k=10, mode="exact"))
    ex_c = cpu.query(q, w, tapi.QuerySpec(k=10, mode="exact"))
    _check_topk((ex_g.dists, ex_g.ids), (ex_c.dists, ex_c.ids), decoded, torch.from_numpy(q),
                torch.from_numpy(w))
    pr_g, pr_c = idx.query(q, w, tapi.QuerySpec(k=10)), cpu.query(q, w, tapi.QuerySpec(k=10))
    assert (pr_g.n_candidates.cpu() == pr_c.n_candidates).float().mean() >= 0.9
    assert torch.all(pr_g.dists.cpu() >= ex_c.dists - 1e-4)


# (n_main, cap, b, P, d, k): odd d, cap = 1, a delta larger than main
TWO_SEG_SHAPES = [
    (50, 20, 3, 17, 7, 5),
    (200, 64, 2, 64, 128, 10),
    (300, 1, 2, 40, 5, 3),
    (10, 300, 2, 16, 33, 4),
    (3000, 800, 37, 700, 128, 10),
]


def _two_seg_ids(rs, n_main, cap, b, P, dev):
    """Ids over both segments with ~25% invalid (negative or >= n_main + cap);
    row 0 wholly in the delta, row 1 (when there is one) all invalid."""
    n_tot = n_main + cap
    ids = rs.integers(-3, n_tot + max(2, n_tot // 3), (b, P)).astype(np.int32)
    ids[0] = rs.integers(n_main, n_tot, P)
    if b > 1:
        ids[1] = n_tot
    return _t(ids, dev)


@pytest.mark.parametrize("case", ["f32", "int8", "int8-scaled", "bf16"])
@pytest.mark.parametrize("n_main,cap,b,P,d,k", TWO_SEG_SHAPES)
def test_two_segment_kernels_match_plain_and_concatenated_table(dev, n_main, cap, b, P, d, k,
                                                                case):
    """Both two-segment kernels against the plain two-segment tail, and bit
    for bit against the single-segment kernel over cat([main, delta]); each
    launch counts on its own counter."""
    from repro_torch import quant
    from repro_torch.kernels._build import (
        GATHER_RERANK,
        GATHER_RERANK_BLOCKED,
        GATHER_RERANK_BLOCKED_TWO_SEG,
        GATHER_RERANK_TWO_SEG,
    )

    rs = np.random.default_rng(n_main + cap + P + d + len(case))
    x = _t(rs.uniform(-1, 1, (n_main, d)).astype(np.float32), dev)
    xd = _t(rs.uniform(-1, 1, (cap, d)).astype(np.float32), dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    ids = _two_seg_ids(rs, n_main, cap, b, P, dev)
    if case == "f32":
        main, delta, scales = x, xd, None
    else:
        main, scales = _quantized(x, case, dev)
        delta = quant.get_codec(case[:4]).encode_rows(
            xd, quant.get_codec("int8").fit_scales(x) if case.startswith("int8") else None)
        if case == "int8":  # the screen pass: integer levels and w·s, no scales
            q, w = quant.proxy_query(q, w, main.dtype, quant.get_codec("int8").fit_scales(x))
    two, one = ((GATHER_RERANK_TWO_SEG, GATHER_RERANK) if case == "f32"
                else (GATHER_RERANK_BLOCKED_TWO_SEG, GATHER_RERANK_BLOCKED))
    before = (two.launches, one.launches)
    got = ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta)
    torch.cuda.synchronize()
    assert (two.launches, one.launches) == (before[0] + 1, before[1])
    want = ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta, force="plain")
    decoded = quant.decode_table(torch.cat([main, delta]), scales)
    _check_topk(got, want, decoded, q, w)
    single = ops.gather_rerank_topk(torch.cat([main, delta]), ids, q, w, k, scales=scales)
    assert torch.equal(got[0], single[0]) and torch.equal(got[1], single[1])
    if b > 1:
        assert torch.all(got[1][1] == -1) and torch.all(torch.isinf(got[0][1]))
    assert bool((got[1][0][got[1][0] >= 0] >= n_main).all())


def _misaligned(t):
    """A contiguous copy of ``t`` whose base sits one value past a 16-byte
    boundary, so the kernels take their scalar (one value per lane) path."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_two_segment_kernel_checks_both_alignments(dev):
    """A delta that starts off the 4-value alignment sends the two-segment
    kernel down its scalar path even with an aligned main table: it then
    equals, bit for bit, the single-segment kernel's scalar path over the
    concatenated table (the 4-wide path sums in another order), and agrees
    with the plain version."""
    rs = np.random.default_rng(9)
    n_main, cap, b, P, d, k = 100, 40, 4, 64, 128, 10
    main = _t(rs.uniform(0, 1, (n_main, d)).astype(np.float32), dev)
    delta = _misaligned(_t(rs.uniform(0, 1, (cap, d)).astype(np.float32), dev))
    q = _t(rs.uniform(0, 1, (b, d)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(b, d))).astype(np.float32), dev)
    ids = _two_seg_ids(rs, n_main, cap, b, P, dev)
    got = ops.gather_rerank_topk(main, ids, q, w, k, delta=delta)
    cat = torch.cat([main, delta])
    _check_topk(got, ops.gather_rerank_topk(main, ids, q, w, k, delta=delta, force="plain"),
                cat, q, w)
    scalar = ops.gather_rerank_topk(_misaligned(cat), ids, q, w, k)
    assert torch.equal(got[0], scalar[0]) and torch.equal(got[1], scalar[1])


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_mutable_engine_on_the_card_matches_the_cpu_path(dev, storage):
    """A mutable index (inserts, deletes in both segments) on the card and
    the same state on the CPU: probe and exact queries agree, no deleted id
    comes back, and the two-segment kernels launch on the card."""
    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.kernels._build import launch_counts, reset_launch_counts

    rs = np.random.default_rng(10)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, max_candidates=64, storage=storage,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    data = rs.uniform(0, 1, (8192, 32)).astype(np.float32)
    extra = rs.uniform(0, 1, (600, 32)).astype(np.float32)
    q = np.concatenate([extra[:32], rs.uniform(0, 1, (32, 32))]).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 32))) + 0.1).astype(np.float32)
    gpu = tapi.Index.build(13, data, cfg, update=tapi.UpdateSpec(delta_capacity=1024))
    gpu, ids = gpu.insert(extra)
    dead = torch.cat([torch.arange(0, 3000, 5, dtype=torch.int32, device="cuda"), ids[1::4]])
    gpu = gpu.delete(dead)
    cpu = tapi.Index(state=gpu.state.to("cpu"), config=cfg, update=gpu.update,
                     delta=gpu.delta.to("cpu"), tombstones=gpu.tombstones.cpu())
    decoded = quant.decode_table(torch.cat([cpu.state.data, cpu.delta.data]), cpu.state.scales)
    name = "gather_rerank_topk_two_seg" if storage == "f32" else \
        "gather_rerank_topk_blocked_two_seg"
    exact = gpu.query(q, w, tapi.QuerySpec(k=10, mode="exact"))
    alive = torch.arange(32) % 4 != 1  # ids[1::4] were deleted
    assert torch.equal(exact.ids.cpu()[:32, 0][alive], ids.cpu()[:32][alive])
    for spec in (tapi.QuerySpec(k=10, mode="exact"), tapi.QuerySpec(k=10),
                 tapi.QuerySpec(k=10, screen_alpha=2.0)):
        reset_launch_counts()
        g = gpu.query(q, w, spec)
        assert launch_counts()[name] >= 1
        c = cpu.query(q, w, spec)
        assert not torch.isin(g.ids.cpu(), dead.cpu()).any()
        rows = g.n_candidates.cpu() == c.n_candidates
        assert rows.float().mean() >= 0.9
        _check_topk((g.dists.cpu()[rows], g.ids.cpu()[rows]), (c.dists[rows], c.ids[rows]),
                    decoded, torch.from_numpy(q)[rows], torch.from_numpy(w)[rows])


# the materializing scan and re-rank: ragged n, b, C and d, b = 1, negative
# weights; rtol/atol 1e-4, the reference's bar (tests/test_kernels_wl1.py)
WL1_SCAN_SHAPES = [(1, 1, 1), (129, 9, 257), (300, 1, 16), (5000, 70, 130), (65536, 64, 128),
                   (257, 65, 40)]  # n one past a tile, b one past a query tile, d ragged
WL1_RERANK_SHAPES = [(1, 1, 1), (3, 130, 257), (1, 7, 16), (64, 4096, 128), (70, 515, 33)]


@pytest.mark.parametrize("n,b,d", WL1_SCAN_SHAPES)
def test_wl1_scan_kernel_matches_plain(dev, n, b, d):
    from repro_torch.kernels._build import WL1_SCAN

    rs = np.random.default_rng(n + b + d)
    data, q, w = (_t(rs.normal(size=s).astype(np.float32), dev) for s in ((n, d), (b, d), (b, d)))
    before = WL1_SCAN.launches
    got = ops.wl1_scan(data, q, w)
    assert WL1_SCAN.launches == before + 1
    torch.testing.assert_close(got, ops.wl1_scan(data, q, w, force="plain"), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,b,d,S", [(2049, 65, 40, 3), (257, 9, 16, 1), (5000, 3, 130, 7)])
def test_wl1_scan_block_walks_several_tiles(dev, n, b, d, S):
    """Fewer row splits than tiles, as scan_row_splits gives past GRID_Y_MAX
    tiles: a block's ring walks on across its tiles. Launched through the
    library's entry with S given; equal bit for bit to the one-tile-per-block
    launch (every output written: both start as NaN) and within 1e-4 of the
    plain version."""
    from repro_torch.kernels._build import WL1_SCAN, raw_stream
    from repro_torch.kernels.wl1_distance import TILE_ROWS, scan_row_splits

    rs = np.random.default_rng(n + b + d)
    data, q, w = (_t(rs.normal(size=s).astype(np.float32), dev) for s in ((n, d), (b, d), (b, d)))
    tiles = -(-n // TILE_ROWS)
    assert scan_row_splits(n) == tiles > S

    def launch(splits):
        out = torch.full((b, n), float("nan"), device=dev)
        err = WL1_SCAN.lib().wl1_scan_launch(data.data_ptr(), q.data_ptr(), w.data_ptr(),
                                             out.data_ptr(), n, d, b, splits, raw_stream(dev))
        WL1_SCAN.check(err, "wl1_scan launch")
        return out

    got = launch(S)
    assert torch.equal(got, launch(tiles))
    torch.testing.assert_close(got, ops.wl1_scan(data, q, w, force="plain"), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,C,d", WL1_RERANK_SHAPES)
def test_wl1_rerank_kernel_matches_plain(dev, b, C, d):
    from repro_torch.kernels._build import WL1_RERANK

    rs = np.random.default_rng(b + C + d)
    pts, q, w = (_t(rs.normal(size=s).astype(np.float32), dev)
                 for s in ((b, C, d), (b, d), (b, d)))
    before = WL1_RERANK.launches
    got = ops.wl1_rerank(pts, q, w)
    assert WL1_RERANK.launches == before + 1
    torch.testing.assert_close(got, ops.wl1_rerank(pts, q, w, force="plain"), rtol=1e-4,
                               atol=1e-4)


# The re-rank is the gathers' row body over contiguous rows: over the rows
# data[ids] (unique ids, k = P) its distances, sorted, are gather_rerank_topk's
# bit for bit in either layout — VEC4 (d % 4 == 0, aligned) or SCALAR (d
# ragged, or both tables misaligned by one float).
RERANK_BITS_CASES = [
    (3, 515, 16, "aligned"),
    (2, 7, 128, "aligned"),
    (4, 515, 128, "aligned"),
    (1, 1, 128, "aligned"),
    (1, 515, 256, "aligned"),
    (2, 300, 130, "aligned"),
    (3, 515, 128, "misaligned"),
    (1, 7, 40, "misaligned"),
]


@pytest.mark.parametrize("b,C,d,align", RERANK_BITS_CASES)
def test_wl1_rerank_equals_gather_rerank_topk_bits(dev, b, C, d, align):
    from repro_torch.kernels._build import WL1_RERANK

    rs = np.random.default_rng(b + C + d)
    n = C + 40
    data = _t(rs.normal(size=(n, d)).astype(np.float32), dev)
    ids = _t(np.stack([rs.permutation(n)[:C] for _ in range(b)]).astype(np.int32), dev)
    q, w = (_t(rs.normal(size=(b, d)).astype(np.float32), dev) for _ in range(2))
    pts = data[ids.long()]
    if align == "misaligned":
        data, pts = _misaligned(data), _misaligned(pts)
        assert data.data_ptr() % 16 == pts.data_ptr() % 16 == 4
    before = WL1_RERANK.launches
    got = ops.wl1_rerank(pts, q, w)
    assert WL1_RERANK.launches == before + 1
    want_d, want_i = ops.gather_rerank_topk(data, ids, q, w, C)
    torch.testing.assert_close(got, ops.wl1_rerank(pts, q, w, force="plain"), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(torch.sort(got, dim=1).values, want_d)
    # and each returned id's distance is the re-rank's at that id's slot
    slot_of = torch.full((b, n), -1, dtype=torch.long, device=dev)
    slot_of.scatter_(1, ids.long(), torch.arange(C, device=dev).expand(b, C).contiguous())
    assert torch.equal(torch.gather(got, 1, torch.gather(slot_of, 1, want_i.long())), want_d)


@pytest.mark.parametrize("view", ["sealed", "mutable", "int8"])
def test_streamed_query_on_the_card_matches_the_cpu_path(dev, view):
    """The streamed early-exit query on the card: at slack 0 it equals the
    card's monolithic query bit for bit and every query exhausts; at slack
    0.1 it agrees with the CPU path over the same index state."""
    import repro_torch.api as tapi
    from repro_torch import quant
    from repro_torch.kernels._build import launch_counts, reset_launch_counts

    rs = np.random.default_rng(12)
    cfg = tapi.IndexConfig(d=32, M=32, K=8, L=16, max_candidates=64,
                           storage="int8" if view == "int8" else "f32",
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    centres = rs.uniform(0.1, 0.9, (512, 32))
    data = (centres[:, None, :] + 1e-3 * rs.normal(size=(512, 16, 32))).reshape(-1, 32)
    q = (centres[:64] + 1e-3 * rs.normal(size=(64, 32))).astype(np.float32)
    w = (1.0 + 0.1 * np.abs(rs.normal(size=(64, 32)))).astype(np.float32)
    update = tapi.UpdateSpec(delta_capacity=1024 if view == "mutable" else 0)
    gpu = tapi.Index.build(13, data.astype(np.float32), cfg, update=update)
    if view == "mutable":
        gpu, ids = gpu.insert((q[:16] + 1e-3 * rs.normal(size=(16, 32))).astype(np.float32))
        gpu = gpu.delete(torch.cat([torch.arange(0, 800, 7, dtype=torch.int32, device="cuda"),
                                    ids[::5]]))
    cpu = tapi.Index(state=gpu.state.to("cpu"), config=cfg, update=gpu.update,
                     delta=gpu.delta.to("cpu"), tombstones=gpu.tombstones.cpu())
    reset_launch_counts()
    on = gpu.query(q, w, tapi.QuerySpec(k=10, early_exit=True, exit_group=4))
    name = {"sealed": "gather_rerank_topk", "mutable": "gather_rerank_topk_two_seg",
            "int8": "gather_rerank_topk_blocked"}[view]
    assert launch_counts()[name] >= 4
    off = gpu.query(q, w, tapi.QuerySpec(k=10))
    for f in ("ids", "dists", "n_candidates"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f
    assert (on.tables_probed == cfg.L).all() and (on.stop_reason == 0).all()
    spec = tapi.QuerySpec(k=10, early_exit=True, exit_group=4, exit_slack=0.1)
    g, c = gpu.query(q, w, spec), cpu.query(q, w, spec)
    rows = (g.n_candidates.cpu() == c.n_candidates) & (g.stop_reason.cpu() == c.stop_reason)
    assert rows.float().mean() >= 0.9
    assert (g.stop_reason.cpu() == 2).any()
    decoded = quant.decode_table(torch.cat([cpu.state.data, cpu.delta.data]), cpu.state.scales)
    _check_topk((g.dists.cpu()[rows], g.ids.cpu()[rows]), (c.dists[rows], c.ids[rows]),
                decoded, torch.from_numpy(q)[rows], torch.from_numpy(w)[rows])


# The f32 kernels' split schedule against the one-warp-per-query schedule
# (gather_rerank_topk_warp_cuda, the stored-type source's reference entry):
# (n, b, P, d, k, splits) with "one" or "many" splits on a 132-SM card;
# k = 40 spans two 32-slot chunks of a list, d = 37 takes the scalar path.
SPLIT_SHAPES = [
    (5000, 2, 20000, 128, 10, "many"),
    (3000, 300, 128, 128, 10, "one"),
    (3000, 3, 9000, 128, 40, "many"),
    (50, 7, 1, 16, 3, "one"),
    (2000, 4, 5000, 37, 10, "many"),
]


def _split_block(rs, n, b, P, d, dev, n_tot=None):
    """Rows that repeat 4 times (equal distances under distinct ids), ids
    with ~20% invalid and repeats, spread so that copies of a row fall on
    both sides of every split boundary; row 0 all invalid, row 1 packed
    (valid first, sentinels last)."""
    n_tot = n if n_tot is None else n_tot
    base = rs.uniform(-1, 1, (max(1, n // 4), d)).astype(np.float32)
    data = np.resize(base, (n, d))
    ids = rs.integers(-3, n_tot + n_tot // 4 + 2, (b, P)).astype(np.int32)
    ids[0] = n_tot
    if b > 1:
        ids[1, P // 2:] = n_tot
    return data, ids


def _old_schedule(data, ids, q, w, k, scales=None, delta=None):
    from repro_torch.kernels.gather_rerank import gather_rerank_topk_warp_cuda

    return gather_rerank_topk_warp_cuda(data, ids, q, w, k, scales=scales, delta=delta)




@pytest.mark.parametrize("n,b,P,d,k,splits", SPLIT_SHAPES)
def test_f32_split_kernel_equals_the_one_warp_schedule(dev, n, b, P, d, k, splits):
    """The f32 kernel equals, bit for bit, the one-warp-per-query schedule on
    the same inputs, and its plain version within rtol/atol 1e-5; one call
    counts one launch whether it made one launch or two."""
    from repro_torch.kernels._build import GATHER_RERANK
    from repro_torch.kernels.gather_rerank import f32_splits

    rs = np.random.default_rng(n + b + P + d + k)
    data, ids = _split_block(rs, n, b, P, d, dev)
    data, ids = _t(data, dev), _t(ids, dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    S = f32_splits(data, ids)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert (S == 1) == (splits == "one")
    before = GATHER_RERANK.launches
    got = ops.gather_rerank_topk(data, ids, q, w, k)
    torch.cuda.synchronize()
    assert GATHER_RERANK.launches == before + 1
    old = _old_schedule(data, ids, q, w, k)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    _check_topk(got, ops.gather_rerank_topk(data, ids, q, w, k, force="plain"), data, q, w)
    assert torch.all(got[1][0] == -1) and torch.all(torch.isinf(got[0][0]))
    if splits == "many":  # rows that tie exactly sit in the top-k, across splits
        gd = got[0].cpu()
        assert bool(((gd[:, 1:] == gd[:, :-1]) & torch.isfinite(gd[:, 1:])).any())


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n_main,cap,b,P,d,k", [
    (4000, 1000, 2, 20000, 128, 10),  # many splits
    (3000, 500, 300, 128, 128, 40),  # one split
])
def test_f32_split_kernel_two_segment_equals_the_one_warp_schedule(dev, n_main, cap, b, P, d, k,
                                                                    aligned):
    """The two-segment f32 kernel against the one-warp two-segment schedule,
    bit for bit, with a delta on the 4-wide path and one whose base is not
    4-aligned (both schedules then take the scalar path); and against the
    plain two-segment version."""
    from repro_torch.kernels._build import GATHER_RERANK_TWO_SEG

    rs = np.random.default_rng(n_main + cap + P + int(aligned))
    data, ids = _split_block(rs, n_main + cap, b, P, d, dev)
    main = _t(data[:n_main], dev)
    delta = _t(data[n_main:], dev)
    if not aligned:
        delta = _misaligned(delta)
    ids = _t(ids, dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(b, d))).astype(np.float32), dev)
    before = GATHER_RERANK_TWO_SEG.launches
    got = ops.gather_rerank_topk(main, ids, q, w, k, delta=delta)
    torch.cuda.synchronize()
    assert GATHER_RERANK_TWO_SEG.launches == before + 1
    old = _old_schedule(main, ids, q, w, k, delta=delta)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    cat = torch.cat([main, delta])
    _check_topk(got, ops.gather_rerank_topk(main, ids, q, w, k, delta=delta, force="plain"),
                cat, q, w)


# The stored-type kernel on its two schedules: (n, b, P, d, k, schedule) on a
# 132-SM card — "many" splits, "one" split, or "warp" (one warp per query:
# fewer 32-slot groups than a split block has warps); k = 20 is the screen's
# keep at k = 10. Layouts (gather_rerank.cuh): bf16 and int8 rows of d <= 128
# in whole pieces (8 bytes of int8, 16 of bf16) are PACKED (d = 64, 48 and 16
# leave lanes past the row's end), d = 256 is VEC4 for every type, d = 37
# SCALAR.
STORED_SHAPES = [
    (5000, 2, 20000, 128, 10, "many"),
    (3000, 300, 1024, 128, 20, "one"),
    (3000, 64, 20, 128, 10, "warp"),
    (3000, 33, 200, 128, 20, "warp"),
    (500, 5, 300, 64, 10, "one"),
    (800, 6, 700, 48, 20, "one"),
    (300, 3, 100, 16, 5, "warp"),
    (600, 4, 900, 256, 10, "one"),
    (2000, 4, 5000, 37, 10, "many"),
]
STORED_CASES = ["f32-scaled", "bf16", "bf16-scaled", "int8", "int8-scaled"]


def _stored(x, xd, q, w, case, rs, dev):
    """(main, delta, scales, q, w) of a stored-type case: rows ``x`` and delta
    rows ``xd`` (or None) encoded as the case says; "int8" is the screen
    pass (integer levels and w·s for q and w, no scales)."""
    from repro_torch import quant

    d = x.shape[1]
    scales = None
    if case.startswith("int8"):
        main, s = quant.get_codec("int8").encode(x)
        delta = None if xd is None else quant.get_codec("int8").encode_rows(xd, s)
        if case == "int8":
            q, w = quant.proxy_query(q, w, main.dtype, s)
        else:
            scales = s
    else:
        dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
        main = x.to(dtype)
        delta = None if xd is None else xd.to(dtype)
    if case.endswith("-scaled") and scales is None:
        scales = _t(rs.uniform(0.5, 2.0, (d,)).astype(np.float32), dev)
    return main.contiguous(), delta, scales, q, w


def _decode(payload, scales):
    """``payload.float() * scales``: what the kernel decodes a row to (an f32
    payload too, which ``quant.decode_table`` passes through unscaled)."""
    out = payload.float()
    return (out if scales is None else out * scales).contiguous()


@pytest.mark.parametrize("segments", [1, 2])
@pytest.mark.parametrize("case", STORED_CASES)
@pytest.mark.parametrize("n,b,P,d,k,schedule", STORED_SHAPES)
def test_stored_kernel_equals_f32_kernel_and_the_one_warp_schedule(dev, n, b, P, d, k, schedule,
                                                                    case, segments):
    """The stored-type kernel on the schedule gather_schedule picks equals,
    bit for bit, the f32 kernel over the decoded table(s) and the one-warp
    schedule over the same payload, and its plain version within rtol/atol
    1e-5; row 0 has no valid id, row 1 is packed; one call counts one
    launch on its own counter."""
    from repro_torch.kernels._build import GATHER_RERANK_BLOCKED, GATHER_RERANK_BLOCKED_TWO_SEG
    from repro_torch.kernels.gather_rerank import WARP_SCHEDULE, stored_schedule

    rs = np.random.default_rng(n + b + P + d + k + len(case) + 7 * segments)
    cap = n // 4 if segments == 2 else 0
    data, ids = _split_block(rs, n, b, P, d, dev)
    x = _t(data[: n - cap], dev)
    xd = _t(data[n - cap:], dev) if segments == 2 else None
    ids = _t(ids, dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    main, delta, scales, q, w = _stored(x, xd, q, w, case, rs, dev)
    S = stored_schedule(main, ids, scales, delta)
    if torch.cuda.get_device_properties(dev).multi_processor_count == 132:
        assert {"warp": S == WARP_SCHEDULE, "one": S == 1, "many": S > 1}[schedule]
    counter = GATHER_RERANK_BLOCKED if delta is None else GATHER_RERANK_BLOCKED_TWO_SEG
    before = counter.launches
    got = ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    dec = _decode(main, scales)
    dec_delta = None if delta is None else _decode(delta, scales)
    f32 = ops.gather_rerank_topk(dec, ids, q, w, k, delta=dec_delta)
    assert torch.equal(got[0], f32[0]) and torch.equal(got[1], f32[1])
    old = _old_schedule(main, ids, q, w, k, scales=scales, delta=delta)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    table = dec if delta is None else torch.cat([dec, dec_delta])
    _check_topk(got, ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta,
                                            force="plain"), table, q, w)
    assert torch.all(got[1][0] == -1) and torch.all(torch.isinf(got[0][0]))


@pytest.mark.parametrize("case", STORED_CASES)
@pytest.mark.parametrize("P", [20, 4000])
def test_stored_two_segment_kernel_with_an_unaligned_delta(dev, case, P):
    """A delta whose base is off the 4-value alignment sends the stored-type
    two-segment kernel (both schedules) down the scalar path: it equals, bit
    for bit, the one-warp schedule and the f32 two-segment kernel over the
    decoded tables with the decoded delta equally unaligned."""
    rs = np.random.default_rng(P + len(case))
    n_main, cap, b, d, k = 2000, 600, 6, 128, 20
    data, ids = _split_block(rs, n_main + cap, b, P, d, dev)
    q = _t(rs.uniform(-1, 1, (b, d)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(b, d))).astype(np.float32), dev)
    main, delta, scales, q, w = _stored(_t(data[:n_main], dev), _t(data[n_main:], dev), q, w,
                                        case, rs, dev)
    delta = _misaligned(delta)
    ids = _t(ids, dev)
    got = ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta)
    old = _old_schedule(main, ids, q, w, k, scales=scales, delta=delta)
    assert torch.equal(got[0], old[0]) and torch.equal(got[1], old[1])
    dec = _decode(main, scales)
    dec_delta = _misaligned(_decode(delta, scales))
    f32 = ops.gather_rerank_topk(dec, ids, q, w, k, delta=dec_delta)
    assert torch.equal(got[0], f32[0]) and torch.equal(got[1], f32[1])
    _check_topk(got, ops.gather_rerank_topk(main, ids, q, w, k, scales=scales, delta=delta,
                                            force="plain"), torch.cat([dec, dec_delta]), q, w)


@pytest.mark.parametrize("P", [256, 20])
def test_int8_widening_is_exact_for_every_byte_value(dev, P):
    """Every int8 value v at each byte position of the two words a lane
    widens (coordinates 0..7): with w = e_j and q = -200 e_j, row r's
    distance is exactly v_rj + 200, so the 256 rows come back in value order
    with distances 72..327 — on the split schedule (P = 256) and on the
    one-warp one (P = 20, the first 20 values)."""
    rs = np.random.default_rng(P)
    n, d, b = 256, 128, 8
    rows = rs.integers(-128, 128, (n, d)).astype(np.int8)
    perms = [rs.permutation(n) for _ in range(b)]
    for j, perm in enumerate(perms):
        rows[:, j] = (perm - 128).astype(np.int8)  # row r holds perm[r] - 128 at coordinate j
    w = np.zeros((b, d), np.float32)
    q = np.zeros((b, d), np.float32)
    for j in range(b):
        w[j, j], q[j, j] = 1.0, -200.0
    ids = np.tile(np.arange(P, dtype=np.int32), (b, 1))
    payload = _t(rows, dev)
    got = ops.gather_rerank_topk(payload, _t(ids, dev), _t(q, dev), _t(w, dev), P)
    gd, gi = (t.cpu().numpy() for t in got)
    for j, perm in enumerate(perms):
        vals = perm[:P].astype(np.int64) - 128
        order = np.argsort(vals, kind="stable")
        assert np.array_equal(gd[j], (vals[order] + 200).astype(np.float32))
        assert np.array_equal(gi[j], order.astype(np.int32))


# The scan's filter-then-select top-k: bit for bit the first k of wl1_scan's
# distances under a stable sort (the same sequential fmaf per distance), on
# ragged shapes (n, b, d off every tile, k past one buffer of 32, one split
# and many) and on tie-heavy data (each row 4 times, across tiles and splits).
SCAN_SELECT_SHAPES = [
    (1, 1, 1, 1),
    (5, 3, 7, 8),  # n < k
    (257, 65, 17, 33),  # one row past a tile, one query past a tile, k > 32
    (5003, 70, 130, 10),
    (70001, 37, 24, 50),  # many splits, a ragged last tile
    (20000, 129, 128, 238),  # k at the shared-memory limit
]


def _stable_sorted_topk(data, q, w, k):
    sd, order = torch.sort(ops.wl1_scan(data, q, w), dim=1, stable=True)
    b, n = sd.shape
    out_d = torch.full((b, k), float("inf"), device=data.device)
    out_i = torch.full((b, k), -1, dtype=torch.int32, device=data.device)
    out_d[:, : min(k, n)] = sd[:, :k]
    out_i[:, : min(k, n)] = order[:, :k].to(torch.int32)
    out_i[~torch.isfinite(out_d)] = -1
    return out_d, out_i


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n,b,d,k", SCAN_SELECT_SHAPES)
def test_scan_topk_equals_scan_and_stable_sort(dev, n, b, d, k, ties):
    from repro_torch.kernels._build import WL1_SCAN_TOPK
    from repro_torch.kernels.wl1_topk import smem_bytes, SMEM_LIMIT

    assert smem_bytes(238) <= SMEM_LIMIT < smem_bytes(239)
    rs = np.random.default_rng(n + 3 * b + 5 * d + k + int(ties))
    if ties:
        base = rs.integers(-4, 5, (max(1, n // 4), d)).astype(np.float32) / 4
        data = np.resize(base, (n, d))  # rows r and r + n // 4 tie exactly
    else:
        data = rs.normal(size=(n, d)).astype(np.float32)
    data, q = _t(data, dev), _t(rs.normal(size=(b, d)).astype(np.float32), dev)
    w = _t(rs.normal(size=(b, d)).astype(np.float32), dev)  # negative weights too
    before = WL1_SCAN_TOPK.launches
    got = ops.wl1_scan_topk(data, q, w, k)
    torch.cuda.synchronize()
    assert WL1_SCAN_TOPK.launches == before + 1
    want = _stable_sorted_topk(data, q, w, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if ties and n >= 8 and k > 1:
        gd = got[0].cpu()
        assert bool(((gd[:, 1:] == gd[:, :-1]) & torch.isfinite(gd[:, 1:])).any())


def test_scan_topk_rows_at_infinity(dev):
    """Rows at +inf never enter: with fewer finite rows than k the list ends
    in (+inf, -1), as wl1_scan + stable sort + the sentinel rule give."""
    rs = np.random.default_rng(9)
    data = rs.normal(size=(600, 12)).astype(np.float32)
    data[5:] = np.inf
    data, q = _t(data, dev), _t(rs.normal(size=(3, 12)).astype(np.float32), dev)
    w = _t(np.abs(rs.normal(size=(3, 12))).astype(np.float32) + 0.1, dev)
    got = ops.wl1_scan_topk(data, q, w, 8)
    want = _stable_sorted_topk(data, q, w, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1][:, 5:].eq(-1).all()


# alsh_project's launch branches (csrc/alsh_project.cu): 256-row tiles when
# ceil(n / 256) * ceil(H / 64) >= 264, else 64-row tiles; within each, the
# widest coordinate chunk whose ring fits (M+1 = 17 and 33: 4, 65: 2 on
# 256-row tiles; 101: 2 and 201: 1 on both). Ragged n, H and d throughout.
PROJECT_BRANCH_SHAPES = [
    (70001, 23, 40, 16),
    (70001, 23, 40, 32),
    (70001, 23, 40, 64),
    (67000, 9, 70, 200),
    (3001, 37, 130, 16),
    (3001, 37, 130, 32),
    (3001, 37, 130, 64),
    (777, 5, 65, 100),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n,d,H,M", PROJECT_BRANCH_SHAPES)
def test_alsh_project_branches_match_plain_and_repeat(dev, n, d, H, M, weighted):
    from repro_torch.kernels.alsh_project import tile_folded

    rs = np.random.default_rng(n + d + H + M + int(weighted))
    levels = _t(rs.integers(-2, M + 3, (n, d), dtype=np.int32), dev)  # some clamped
    folded = _t(rs.normal(size=(H, d, M + 1)).astype(np.float32), dev)
    w = _t(rs.normal(size=(n, d)).astype(np.float32), dev) if weighted else None
    tiled = tile_folded(folded)
    got = ops.alsh_project(levels, folded, w, tiled=tiled)
    again = ops.alsh_project(levels, folded, w)  # the kernel makes its own relayout
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    want = ops.alsh_project(levels.clamp(0, M), folded, w, force="plain")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# quality-first planning and the tuner on the card
# ---------------------------------------------------------------------------


def _plan_problem():
    rs = np.random.default_rng(20)
    data = rs.uniform(0, 1, (3000, 16)).astype(np.float32)
    q = rs.uniform(0, 1, (64, 16)).astype(np.float32)
    w = (np.abs(rs.normal(size=(64, 16))) + 0.1).astype(np.float32)
    return data, q, w


def test_quality_query_equals_planned_query_on_the_card(dev):
    import warnings

    import repro_torch.api as tapi

    data, q, w = _plan_problem()
    quality = tapi.QualitySpec(k=10, recall_target=0.9, calibration_queries=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        idx = tapi.Index.build(3, data, quality, family="theta")
    assert idx.device.type == "cuda"
    plan = idx.plan(quality)
    a, b = idx.query(q, w, quality), idx.query(q, w, plan)
    for f in ("ids", "dists", "n_candidates"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    ladder = idx.plan_ladder(quality)
    assert ladder[0] == plan
    rep = idx.explain(q, w, quality)
    assert rep.provenance == "calibrated" and rep.plan_build_s > 0
    assert torch.equal(rep.result.ids, a.ids)


@pytest.mark.parametrize("storage", ["f32", "int8"])
def test_same_index_plans_the_same_on_cpu_and_card(dev, storage):
    """One index state, on the CPU (plain versions) and on the card (the
    hand kernels): the same samples (CPU generators) give the same plan."""
    import dataclasses
    import warnings

    import repro_torch.api as tapi

    data, _, _ = _plan_problem()
    cfg = tapi.IndexConfig(d=16, M=16, K=10, L=16, max_candidates=64, storage=storage,
                           space=tapi.BoundedSpace(0.0, 1.0, 16.0))
    cpu = tapi.Index.build(4, data, cfg, device="cpu")
    card = tapi.Index(state=cpu.state.to("cuda"), config=cfg)
    quality = tapi.QualitySpec(k=10, recall_target=0.9, calibration_queries=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        a, b = cpu.plan(quality), card.plan(quality)
    fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
    sa, sb = fa.pop("predicted_success"), fb.pop("predicted_success")
    assert fa == fb
    np.testing.assert_allclose(sa, sb, rtol=1e-6)


def test_spawn_scan_equals_inline_on_the_card(dev, tmp_path):
    from repro_torch import tuner

    from repro_torch.kernels import _build

    space = tuner.ScanSpace(profiles=(tuner.DataProfile(n=4096, d=16),), families=("theta",),
                            K=(8,), L=(8,), n_probes=(1, 2, 4), window=(64,), k=5, queries=32)
    _build.reset_launch_counts()
    inline = tuner.run_scan(space, tmp_path / "inline.jsonl")
    inline_launches = _build.launch_counts()
    _build.reset_launch_counts()
    pooled = tuner.run_scan(space, tmp_path / "pooled.jsonl", workers=2)
    # the workers' launches reach the parent's counts
    assert _build.launch_counts() == inline_launches
    assert inline_launches["wl1_scan_topk"] and inline_launches["gather_rerank_topk"]
    assert len(inline) == len(pooled) == 3
    for a, b in zip(inline, pooled):
        for key in ("trial_id", "recall", "cand_frac", "cost", "mem_bytes", "W"):
            assert a[key] == b[key], key


@pytest.mark.parametrize("impl", ["gather", "onehot"])
def test_impl_spec_raises_on_the_card(dev, impl):
    """On the card the query projection is the hand kernel only."""
    import repro_torch.api as tapi

    data, q, w = _plan_problem()
    cfg = tapi.IndexConfig(d=16, M=16, K=10, L=4, max_candidates=64,
                           space=tapi.BoundedSpace(0.0, 1.0, 16.0))
    idx = tapi.Index.build(4, data, cfg)
    with pytest.raises(ValueError, match="runs on CPU tensors only"):
        idx.query(q, w, tapi.QuerySpec(k=5, impl=impl))


def _window_block(b, windows, C, n, seed, dev, starts_per_row=4, max_gap=12):
    """(b, windows·C) int32, shaped like the probe's raw block: each window
    holds a random number of ascending ids from a bucket start, then the
    window sentinel n + C. A row's windows start at one of
    ``starts_per_row`` points, so they share ids; ids past n - 1 are padding
    as well."""
    g = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.randint(0, max(n, 1), (b, starts_per_row), generator=g, device=dev)
    start = torch.gather(starts, 1, torch.randint(0, starts_per_row, (b, windows), generator=g,
                                                  device=dev))
    gaps = torch.randint(1, max_gap, (b, windows, C), generator=g, device=dev)
    ids = start[:, :, None] + torch.cumsum(gaps, dim=2) - gaps[:, :, :1]
    fill = torch.randint(0, C + 1, (b, windows, 1), generator=g, device=dev)
    ids = torch.where(torch.arange(C, device=dev) < fill, ids, n + C)
    return ids.reshape(b, windows * C).to(torch.int32)


def _dedupe_case(case, dev):
    """(cand, n) of one named case: the two sift1m cells' shapes, the stream
    group and two-segment widths, odd widths and ranges, b = 1, and id ranges
    that take several tiles or several walk rounds of the kernel."""
    g = torch.Generator(device=dev).manual_seed(len(case))

    def rand(b, P, hi):
        return torch.randint(0, hi, (b, P), generator=g, device=dev, dtype=torch.int32)

    if case == "multiprobe-cell":
        n, cand = 1_000_000, _window_block(1000, 256, 128, 1_000_000, 1, dev)
    elif case == "probe-cell":
        n, cand = 1_000_000, _window_block(10_000, 32, 128, 1_000_000, 2, dev)
    elif case == "stream-group":  # k heap ids + G·C window slots = 10 + 8·128
        n = 262_144 + 8192
        cand = torch.cat([rand(1024, 10, n + 1), _window_block(1024, 8, 128, n, 3, dev)], dim=1)
    elif case == "two-segment":  # L·P·C main slots + the delta's cap, n_valid = n + cap
        n_main, cap = 262_144, 8192
        n = n_main + cap
        delta = torch.where(rand(64, cap, 4) == 0, n_main + torch.arange(cap, device=dev), n)
        cand = torch.cat([_window_block(64, 32, 128, n_main, 4, dev), delta.to(torch.int32)],
                         dim=1)
    elif case == "odd-widths":  # P and n multiples of neither 32 nor the block
        n = 999_983
        cand = torch.cat([_window_block(7, 8, 129, n, 5, dev), rand(7, 5, n + 200)], dim=1)
    elif case == "one-query":
        n, cand = 50, rand(1, 33, 60)
    elif case == "small-range":
        n, cand = 30, rand(6, 24, 39)
    elif case == "empty-range":
        n, cand = 0, rand(3, 40, 5)
    elif case == "many-words":  # more nonzero bitmap words than one walk step lists
        n, cand = 1_000_000, rand(4, 20_000, 1_005_000)
    elif case == "two-rounds":  # more summary words than threads in one tile
        n, cand = 1_400_000, _window_block(64, 40, 128, 1_400_000, 6, dev)
    elif case == "tiled":  # above one tile's ids: two tiles, a sparse row
        n, cand = 2_500_000, rand(5, 5000, 2_600_000)
    elif case == "three-tiles":
        n, cand = 4_000_000, _window_block(3, 40, 128, 4_000_000, 7, dev, max_gap=2000)
    elif case == "wide-range":  # a short row over three tiles
        n, cand = 4096 * 1024 + 1, rand(9, 4096, 4096 * 1024 + 100)
    else:
        raise ValueError(case)
    if cand.shape[0] >= 3:
        cand[0] = n  # all sentinels
        cand[1] = max(n - 1, 0)  # one id repeated (the last valid one)
        cand[2, ::2] = n + 128  # the window sentinel and ids past n beside valid ones
        cand[2, 1::4] = 0
    return cand.contiguous(), n


# each case and the id-range tiles the kernel walks it in
DEDUPE_CASES = {"multiprobe-cell": 1, "probe-cell": 1, "stream-group": 1, "two-segment": 1,
                "odd-widths": 1, "one-query": 1, "small-range": 1, "empty-range": 0,
                "many-words": 1, "two-rounds": 1, "tiled": 2, "three-tiles": 3,
                "wide-range": 3}


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", list(DEDUPE_CASES))
def test_dedupe_candidates_kernel_equals_plain(dev, case, aligned):
    """Packed ids and counts bit-equal to the two-sort plain version, with
    one launch (and none for the plain version). With ``aligned`` False the
    block starts 4 bytes past a 16-byte boundary, so the kernel reads it id
    by id instead of in 16-byte groups."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.dedupe_candidates import tile_plan

    cand, n = _dedupe_case(case, dev)
    assert tile_plan(n)[0] == DEDUPE_CASES[case]
    if not aligned:
        buf = torch.empty(cand.numel() + 1, dtype=torch.int32, device=dev)
        buf[1:] = cand.flatten()
        cand = buf[1:].view(cand.shape)
        assert cand.data_ptr() % 16 != 0 and cand.is_contiguous()
    before = _build.launch_counts()["dedupe_candidates"]
    got, got_n = ops.dedupe_candidates(cand, n)
    assert _build.launch_counts()["dedupe_candidates"] == before + 1
    want, want_n = ops.dedupe_candidates(cand, n, force="plain")
    assert _build.launch_counts()["dedupe_candidates"] == before + 1  # the plain version: none
    torch.cuda.synchronize()
    assert got.dtype == got_n.dtype == torch.int32
    assert got.shape == cand.shape and got_n.shape == (cand.shape[0],)
    assert torch.equal(got_n, want_n)
    assert torch.equal(got, want)
    if cand.shape[0] >= 3:
        assert int(got_n[0]) == 0 and int(got_n[1]) == (1 if n else 0)


@pytest.mark.parametrize("n,plan", [
    (0, (0, 0)), (1, (1, 1)), (1024, (1, 1)), (1025, (1, 2)), (1_000_000, (1, 977)),
    (1384 * 1024, (1, 1384)), (1384 * 1024 + 1, (2, 693)), (2_500_000, (2, 1221)),
    (4_000_000, (3, 1303)),
])
def test_dedupe_tile_plan(dev, n, plan):
    """The kernel's cut of the id range: equal tiles of at most 1,384
    summary words of 1,024 ids, covering [0, n), each block's shared memory
    within the card's 227 KB."""
    from repro_torch.kernels.dedupe_candidates import tile_plan

    tiles, words, smem = tile_plan(n)
    assert (tiles, words) == plan
    assert tiles * words * 1024 >= n and smem <= 227 * 1024


@pytest.mark.parametrize("mode", ["probe", "multiprobe"])
def test_query_on_the_card_dedupes_without_torch_sort(dev, monkeypatch, mode):
    """A sealed probe or multiprobe query on the card launches the dedupe
    kernel once and never calls ``torch.sort``; its answer equals the one
    with the plain dedupe."""
    import repro_torch.api as tapi
    from repro_torch.kernels import _build

    rs = np.random.default_rng(33)
    cfg = tapi.IndexConfig(d=32, M=32, K=12, L=8, max_candidates=64,
                           space=tapi.BoundedSpace(0.0, 1.0, 32.0))
    idx = tapi.Index.build(13, rs.uniform(0, 1, (4096, 32)).astype(np.float32), cfg)
    q = rs.uniform(0, 1, (32, 32)).astype(np.float32)
    w = (np.abs(rs.normal(size=(32, 32))) + 0.1).astype(np.float32)
    spec = tapi.QuerySpec(k=10, mode=mode, n_probes=8, max_flips=3)

    def refuse(*args, **kwargs):
        raise AssertionError("torch.sort called")

    before = _build.launch_counts()["dedupe_candidates"]
    with monkeypatch.context() as m:
        m.setattr(torch, "sort", refuse)
        res = idx.query(q, w, spec)
    assert _build.launch_counts()["dedupe_candidates"] == before + 1
    kernel = ops.dedupe_candidates
    with monkeypatch.context() as m:
        m.setattr(ops, "dedupe_candidates", lambda cand, n: kernel(cand, n, force="plain"))
        want = idx.query(q, w, spec)
    for field in ("dists", "ids", "n_candidates"):
        assert torch.equal(getattr(res, field), getattr(want, field)), field
