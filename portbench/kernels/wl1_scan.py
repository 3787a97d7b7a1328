"""Work of ``wl1_scan``: the materializing exact scan, (b, n) distances.
No path of the current cells calls it.

Bytes: the (n, d) table, the queries and weights read once, the (b, n)
distances written once. Operations: 3 a term over b·n·d terms.
"""

SYMBOLS = ("wl1_scan_kernel",)


def work(n: int, b: int, d: int) -> tuple[int, int]:
    return 4 * n * d + 2 * 4 * b * d + 4 * b * n, 3 * b * n * d


def batch_shapes(batch: dict) -> list[dict]:
    return []
