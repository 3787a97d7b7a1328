"""The bfloat16-row cell at a tiny size on the CPU: the program answers
correctly from its bf16 rows, the control and a program that answers from
f32 rows do not; the stored-row reference against brute force over the
rounded rows and against ``wl1_alsh``; the data handed over from the host;
the count of the gather over 2-byte rows."""

import copy

import numpy as np
import pytest
import torch

from portbench import bench, harness, peaks
from portbench.references import wl1_alsh
from portbench.references import wl1_alsh_stored as S
from portbench.tests.tiny import INDEX, SIZES

CELL = "gist1m-theta.bf16-b1k"
SEED = 2**33 + 7  # beyond 32 signed bits, as a run's seed may be
TRAFFICS = ("bf16-b1k", "multiprobe-b1k")


def tiny_bf16_cell(traffic: str) -> bench.Cell:
    """The gist1m-theta-bf16 configuration cut to the tiny SIZES, under
    ``traffic`` with batches of 64 and the bf16 cell's limits."""
    cell = bench.load_cell(CELL)
    config = copy.deepcopy(cell.config)
    config.update(SIZES)
    config["index"].update(INDEX)
    tr = bench.read_json(bench.PORTBENCH / "traffic" / f"{traffic}.json")
    tr["batch"] = 64
    return bench.Cell(f"tiny.bf16.{traffic}", 1, config, tr, cell.limits, cell.end_to_end,
                      cell.per_layer)


@pytest.mark.parametrize("traffic", TRAFFICS)
def test_sound_bf16_run_is_correct(traffic):
    r = harness.run(tiny_bf16_cell(traffic), SEED, 0.3, False, device="cpu")
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and set(r["metrics"]) >= {"qps", "setup_s"}


def test_bf16_control_is_not_correct():
    out = harness.control(tiny_bf16_cell("bf16-b1k"), SEED, device="cpu")
    assert not out["correct"], out["checks"]


def test_answers_from_f32_rows_are_not_correct(monkeypatch):
    """The bf16 codec's encode made the identity: the index keeps its f32
    rows and answers from them."""
    from repro_torch.quant import codecs

    real = codecs.RowCodec.encode

    def identity(self, data):
        return (data, None) if self.name == "bf16" else real(self, data)

    monkeypatch.setattr(codecs.RowCodec, "encode", identity)
    r = harness.run(tiny_bf16_cell("bf16-b1k"), SEED, 0.3, False, device="cpu")
    assert not r["correct"], r["checks"]
    assert r["checks"]["dist_gap"]["value"] > r["checks"]["dist_gap"]["limit"]


REF_INDEX = dict(M=32, K=6, L=4, family="theta", W=8.0, max_candidates=512,
                 space=[0.0, 1.0, 32.0], storage="bf16")


def _inputs(n=512, d=8, b=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.rand((n, d), generator=g)
    q = torch.rand((b, d), generator=g)
    w = 1.0 + 0.1 * torch.randn((b, d), generator=g).abs()
    return x, q, w


def test_stored_distances_are_brute_force_over_the_rounded_rows():
    x, q, w = _inputs()
    ref = S.Reference(x, 7, x.shape[1], REF_INDEX)
    xr = x.to(torch.bfloat16).double()
    dist = (w.double()[:, None, :] * (xr[None] - q.double()[:, None]).abs()).sum(-1)
    order = np.lexsort((np.broadcast_to(np.arange(x.shape[0]), dist.shape), dist.numpy()), axis=1)
    d, i = ref.exact(q, w, 10, rows_per_block=100)
    np.testing.assert_array_equal(i.numpy(), order[:, :10])
    np.testing.assert_allclose(d.numpy(), np.take_along_axis(dist.numpy(), order, 1)[:, :10],
                               rtol=1e-12)
    ids = torch.arange(x.shape[0])[None].expand(q.shape[0], -1)
    torch.testing.assert_close(ref.distances(q, w, ids), dist, rtol=1e-12, atol=0)
    # the rounding is what it measures: the f32 rows' distances differ
    assert not torch.allclose(wl1_alsh.Reference(x, 7, 8, REF_INDEX).distances(q, w, ids), dist,
                              rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_probes,max_flips", [(1, 0), (8, 2)])
def test_stored_reference_hashes_as_wl1_alsh(n_probes, max_flips):
    """The copy's draw, keys, sorted tables and candidates are the
    original's for the same seed: both hash the raw rows."""
    x, q, w = _inputs(n=600)
    index = dict(REF_INDEX, K=4, L=3, max_candidates=16)
    ref, orig = S.Reference(x, 2**40 + 3, 8, index), wl1_alsh.Reference(x, 2**40 + 3, 8, index)
    g = S.Geometry(8, index)
    assert torch.equal(S.draw_folded(11, g), wl1_alsh.draw_folded(11, wl1_alsh.Geometry(8, index)))
    assert torch.equal(ref.table, orig.table) and torch.equal(ref.sorted, orig.sorted)
    keys = ref.keys(q, w, n_probes, max_flips)
    assert torch.equal(keys, orig.keys(q, w, n_probes, max_flips))
    for a, b in zip(ref.candidates(keys), orig.candidates(keys)):
        assert torch.equal(a, b)


def test_stored_reference_raises_for_other_storage():
    x, _, _ = _inputs(n=64)
    for storage in ("f32", "int8"):
        with pytest.raises(ValueError, match="bf16"):
            S.Reference(x, 7, 8, dict(REF_INDEX, storage=storage))


def test_host_clusters_are_the_clusters_rows_and_queries():
    cfg = bench.load_cell(CELL).config
    host = bench.load_module(bench.PORTBENCH / "datagen" / "clusters_host.py")
    plain = bench.load_module(bench.PORTBENCH / "datagen" / "clusters.py")
    a = host.make(cfg["data"], 512, 16, 99, "cpu")
    b = plain.make(cfg["data"], 512, 16, 99, "cpu")
    assert a.rows.device.type == "cpu" and torch.equal(a.rows, b.rows)
    for x, y in zip(a.batch(8, 5), b.batch(8, 5)):
        assert torch.equal(x, y)


# (kernel, shape, bound in ms as PERF.md's kernel table gives it, digits kept):
# its "bf16, service candidates" row (d=128, b=1024, P=4096) and the f32 row
# at the same candidates; valid = the bf16 row's 857 MB gathered at 256 B a
# row, distinct as the f32 row's byte bound needs it. Both counts count one
# way (chip_smoke.py's gather_bound): only the row bytes differ, so the bf16
# bound is the operations' and the f32 one the bytes'.
SERVICE = dict(b=1024, slots=4096, valid=3_347_656, distinct=177_000, d=128, k=10)
ANCHORS = [("gather_rerank_topk_bf16", SERVICE, 0.0192, 4),
           ("gather_rerank_topk", SERVICE, 0.0324, 4)]


@pytest.mark.parametrize("kernel,shape,bound_ms,digits", ANCHORS, ids=[a[0] for a in ANCHORS])
def test_count_reproduces_the_kernel_table_bound(kernel, shape, bound_ms, digits):
    count = bench.counts()[kernel]
    assert round(1e3 * peaks.least_time(*count.work(**shape)), digits) == bound_ms


def test_bf16_count_halves_the_row_bytes_and_keeps_the_symbols():
    counts = bench.counts()
    f32, bf16 = counts["gather_rerank_topk"], counts["gather_rerank_topk_bf16"]
    assert bf16.SYMBOLS == f32.SYMBOLS
    shape = dict(SERVICE, d=960)
    (b32, o32), (b16, o16) = f32.work(**shape), bf16.work(**shape)
    assert o16 == o32 and b32 - b16 == 2 * shape["distinct"] * shape["d"]
    batch = dict(mode="probe", b=1000, d=960, n=10**6, k=10, K=12, L=32, M=32, C=128, P=1,
                 valid=2_000_000, distinct=900_000)
    assert bf16.batch_shapes(batch) == f32.batch_shapes(batch)


def test_bf16_roofline_reads_only_bf16_storage():
    reader = bench.load_module(bench.PORTBENCH / "metrics" / "roofline.gather_rerank_topk_bf16.py")
    ctx = harness.Context(config={"index": {"storage": "f32"}}, trace=object())
    assert reader.read(ctx) is None
    assert reader.read(harness.Context(config={"index": {"storage": "bf16"}}, trace=None)) is None
