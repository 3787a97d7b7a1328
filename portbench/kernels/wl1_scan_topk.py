"""Work of ``wl1_scan_topk``: the streaming exact scan with its top-k, one
call an exact batch.

Bytes: the (n, d) table once, the queries and weights once, the (b, k)
distances and ids written once. Operations: 3 a term over b·n·d terms.
"""

SYMBOLS = ("wl1_scan_partial", "wl1_scan_merge")


def work(n: int, b: int, d: int, k: int) -> tuple[int, int]:
    return 4 * n * d + 2 * 4 * b * d + 8 * b * k, 3 * b * n * d


def batch_shapes(batch: dict) -> list[dict]:
    if batch["mode"] != "exact":
        return []
    return [dict(n=batch["n"], b=batch["b"], d=batch["d"], k=batch["k"])]
