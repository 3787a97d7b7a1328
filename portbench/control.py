"""The control of the comparison: the plain reference computed in bfloat16,
in the program's place, answers every batch of a cell's pool, and the
comparison that decides ``correct`` judges it against the float64
reference. Its numbers are the upper readings the limits are set below;
the benchmark's own runs never run it.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

prints one JSON line a seed: the numbers, their limits and ``correct``,
which has to come out false.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)

    from portbench import bench, harness

    cell = bench.load_cell(args.workload)
    for seed in args.seed:
        t0 = time.perf_counter()
        out = harness.control(cell, seed)
        out.update(workload=cell.name, seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
