"""Work of ``gather_rerank_topk``: the fused gather, exact re-rank and
top-k over a batch's deduplicated candidate slots, one call a probe or
multiprobe batch.

Bytes: each distinct candidate row read once at 4 bytes a value, the
(b, slots) candidate ids, the queries and the weights read once, the
(b, k) distances and ids written once. Operations: 3 a term (a subtract
and a fused multiply-add), over the valid candidate slots times d. The
valid and distinct counts are the reference's, not the program's.
"""

SYMBOLS = ("gather_rerank_split_kernel", "gather_rerank_merge_kernel", "gather_rerank_warp_kernel")


def work(b: int, slots: int, valid: int, distinct: int, d: int, k: int) -> tuple[int, int]:
    nbytes = 4 * distinct * d + 4 * b * slots + 2 * 4 * b * d + 8 * b * k
    return nbytes, 3 * valid * d


def batch_shapes(batch: dict) -> list[dict]:
    if batch["mode"] not in ("probe", "multiprobe"):
        return []
    return [dict(b=batch["b"], slots=batch["L"] * batch["P"] * batch["C"], valid=batch["valid"],
                 distinct=batch["distinct"], d=batch["d"], k=batch["k"])]
