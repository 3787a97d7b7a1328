"""Work of ``gather_rerank_topk`` over rows stored as bfloat16: the fused
gather, decode, exact re-rank and top-k over a batch's deduplicated
candidate slots, one call a probe or multiprobe batch.

Counted as ``gather_rerank_topk`` counts the f32 kernel, with each distinct
candidate row read once at 2 bytes a value: the (b, slots) candidate ids,
the queries and the weights read once, the (b, k) distances and ids written
once; 3 operations a term (a subtract and a fused multiply-add; the widening
of a bfloat16 value is a shift, not counted). The symbols and the batch
shapes are the f32 count's: the stored-type kernels are instantiations of
the same templates, and a cell whose rows are bfloat16 runs only those.
"""

from portbench import bench

f32 = bench.load_module(bench.PORTBENCH / "kernels" / "gather_rerank_topk.py")

SYMBOLS = f32.SYMBOLS
batch_shapes = f32.batch_shapes


def work(b: int, slots: int, valid: int, distinct: int, d: int, k: int) -> tuple[int, int]:
    nbytes = 2 * distinct * d + 4 * b * slots + 2 * 4 * b * d + 8 * b * k
    return nbytes, 3 * valid * d
