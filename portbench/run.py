"""Run one cell of the benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic, limits
and metrics come from ``BENCHMARK.json`` and the files it names under
``portbench/``. With ``--trace 0`` the result carries the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics read from a profiler
trace of the same window. Exits non-zero and prints no result without the
CUDA cards the cell asks for, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    # one process with one host thread: the program's host ops are small,
    # and a pool of threads contending with the host's other work spreads
    # the runs
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    from portbench import bench, harness

    cell = bench.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        harness.log(f"[portbench] {cell.name} needs {cell.chips} CUDA card(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), device="cuda",
                         t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"[portbench] forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
