"""Work of ``alsh_project``: the weighted projection of a query batch over
the folded tables (the §4.2.3 lookup), one call a probe or multiprobe batch.

Bytes: the levels (and weights) read once, the (H, d, M+1) table read once,
the (rows, H) projections written once. Operations: one add a term, and a
multiply more where the rows are weighted.
"""

SYMBOLS = ("alsh_project_kernel",)


def work(rows: int, d: int, hashes: int, levels: int, weighted: bool) -> tuple[int, int]:
    nbytes = 4 * rows * d * (2 if weighted else 1) + 4 * hashes * d * levels + 4 * rows * hashes
    flops = rows * hashes * d * (2 if weighted else 1)
    return nbytes, flops


def batch_shapes(batch: dict) -> list[dict]:
    if batch["mode"] not in ("probe", "multiprobe"):
        return []
    return [dict(rows=batch["b"], d=batch["d"], hashes=batch["K"] * batch["L"],
                 levels=batch["M"] + 1, weighted=True)]
