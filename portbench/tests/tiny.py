"""A cell of the benchmark's shape at a size the CPU runs in a second."""

from __future__ import annotations

import copy

from portbench import bench

SIZES = dict(rows=4096, dim=16, queries=256)
INDEX = dict(K=8, L=8, max_candidates=32)
TRAFFICS = ("probe-b1k", "multiprobe-b1k", "exact-b1k")


def tiny_cell(traffic: str, limits_of: str | None = None) -> bench.Cell:
    """The sift1m-theta configuration and ``traffic`` cut to SIZES, with the
    limits of the benchmark's cell of that traffic."""
    cell = bench.load_cell(limits_of or _cell_of(traffic))
    config = copy.deepcopy(cell.config)
    config.update(SIZES)
    config["index"].update(INDEX)
    tr = bench.read_json(bench.PORTBENCH / "traffic" / f"{traffic}.json")
    tr["batch"] = 64
    if "check_sample" in tr:
        # the sample takes every query, so that a fault in one answer is judged
        # however few batches a loaded CPU finishes in the window
        tr["check_sample"] = tr["batch"]
    return bench.Cell(f"tiny.{traffic}", 1, config, tr, cell.limits, cell.end_to_end,
                      cell.per_layer)


def _cell_of(traffic: str) -> str:
    for w in bench.read_json(bench.ROOT / "BENCHMARK.json")["workloads"]:
        if w["traffic"] == traffic:
            return w["name"]
    raise KeyError(traffic)
