"""Work of ``dedupe_candidates``: the candidate dedupe of a probe or
multiprobe batch, one call a batch.

Bytes: the (b, slots) candidate ids read once, the (b, slots) packed ids and
the (b,) counts written once, at 4 bytes each. No counted operations.
"""

SYMBOLS = ("dedupe_candidates_kernel",)


def work(b: int, slots: int) -> tuple[int, int]:
    return 8 * b * slots + 4 * b, 0


def batch_shapes(batch: dict) -> list[dict]:
    if batch["mode"] not in ("probe", "multiprobe"):
        return []
    return [dict(b=batch["b"], slots=batch["L"] * batch["P"] * batch["C"])]
