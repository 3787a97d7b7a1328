"""The kernel counts reproduce the bounds of PERF.md's kernel table from
their shapes (bound = the larger of bytes at 3.35 TB/s and operations at
67 TFLOP/s)."""

import pytest

from portbench import bench, peaks

ANCHORS = [
    # (kernel, shape, bound in ms as the kernel table gives it, digits kept)
    ("wl1_scan_topk", dict(n=262_144, b=1024, d=128, k=10), 1.538, 3),
    ("wl1_scan", dict(n=65_536, b=64, d=128), 0.024, 3),
    ("alsh_project", dict(rows=262_144, d=128, hashes=384, levels=33, weighted=False), 0.192, 3),
    ("alsh_project", dict(rows=1024, d=128, hashes=384, levels=33, weighted=True), 0.0027, 4),
    ("gather_rerank_topk", dict(b=1, slots=8202, valid=5382, distinct=5382, d=128, k=10),
     0.00083, 5),
]


@pytest.mark.parametrize("kernel,shape,bound_ms,digits", ANCHORS,
                         ids=[f"{a[0]}-{i}" for i, a in enumerate(ANCHORS)])
def test_count_reproduces_the_kernel_table_bound(kernel, shape, bound_ms, digits):
    count = bench.counts()[kernel]
    assert round(1e3 * peaks.least_time(*count.work(**shape)), digits) == bound_ms


def test_batch_shapes_follow_the_mode():
    batch = dict(mode="probe", b=1000, d=128, n=10**6, k=10, K=12, L=32, M=32, C=128, P=1,
                 valid=2_000_000, distinct=900_000)
    counts = bench.counts()
    assert counts["alsh_project"].batch_shapes(batch)[0]["hashes"] == 384
    assert counts["gather_rerank_topk"].batch_shapes(batch)[0]["slots"] == 4096
    assert counts["wl1_scan_topk"].batch_shapes(batch) == []
    exact = dict(batch, mode="exact")
    assert counts["wl1_scan_topk"].batch_shapes(exact) == [dict(n=10**6, b=1000, d=128, k=10)]
    assert counts["gather_rerank_topk"].batch_shapes(exact) == []
