"""Offline autotuning launcher: scan the knob grid, ship the Pareto table —
counterpart of ``repro.launch.tune`` (same flags and outputs, plus
``--device``).

  1. assemble a :class:`~repro_torch.tuner.space.ScanSpace` from the CLI
     axes (family × K × L × W × probes × window, crossed with n × d × skew
     data profiles),
  2. run (or RESUME) the scan against the JSONL trial store on the device
     (default: the CUDA card) — completed trial ids are skipped, so
     re-running the same command after a crash or a ``--max-trials`` stop
     picks up where it left off,
  3. when the grid is covered, reduce the records to the per-(family,
     profile) Pareto frontier and write the versioned ``tuning_table.json``
     next to the store.

The table is what planners consume::

    table = TuningTable.load("results/tuning/tuning_table.json")
    index = Index.build(seed, data, quality, planner=Planner(table=table))

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune                  # default grid, on the card
  PYTHONPATH=src python -m repro_torch.launch.tune --device cpu --n 1024 --K 8 --L 16
  PYTHONPATH=src python -m repro_torch.launch.tune --n 4096 16384 --workers 4
  PYTHONPATH=src python -m repro_torch.launch.tune --max-trials 20  # budgeted slice
  (rerun the same command to resume; the store + table live under --out)
"""

from __future__ import annotations

import argparse
import json
import os


def build_space(args) -> "ScanSpace":
    """The CLI axes as a declarative ScanSpace (shared with tests)."""
    from repro_torch.tuner import DataProfile, ScanSpace, grid
    from repro_torch.tuner.space import AUTO_WIDTH

    profiles = tuple(
        DataProfile(n=n, d=args.d, skew=skew, source=args.source)
        for n in args.n
        for skew in args.skew
    )
    W = tuple(AUTO_WIDTH if w == AUTO_WIDTH else float(w) for w in args.W)
    return ScanSpace(
        profiles=profiles,
        families=tuple(args.family),
        K=grid(*args.K),
        L=grid(*args.L),
        W=W,
        n_probes=grid(*args.probes),
        window=grid(*args.window),
        k=args.k,
        queries=args.queries,
        base_seed=args.seed,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="repro_torch.tuner offline scan -> Pareto tuning table"
    )
    ap.add_argument("--out", default="results/tuning",
                    help="output directory (trial store + tuning_table.json)")
    ap.add_argument("--family", nargs="+", default=["theta", "l2"],
                    help="hash families to scan")
    ap.add_argument("--n", nargs="+", type=int, default=[4096],
                    help="database sizes (one data profile per n x skew)")
    ap.add_argument("--d", type=int, default=16, help="dimensionality")
    ap.add_argument("--skew", nargs="+", type=float, default=[1.0],
                    help="weight-distribution skews (1.0 = planner reference)")
    ap.add_argument("--source", default="uniform",
                    choices=["uniform", "clustered"],
                    help="synthetic data source for every profile")
    ap.add_argument("--K", nargs="+", type=int, default=[8, 12, 16],
                    help="hashes per table")
    ap.add_argument("--L", nargs="+", type=int, default=[16, 32, 64],
                    help="table counts")
    ap.add_argument("--W", nargs="+", default=["auto"],
                    help="l2 bucket widths ('auto' = planner-anchored)")
    ap.add_argument("--probes", nargs="+", type=int, default=[1, 4, 16],
                    help="multiprobe bucket counts (theta only)")
    ap.add_argument("--window", nargs="+", type=int, default=[256],
                    help="per-table candidate windows")
    ap.add_argument("--k", type=int, default=10, help="recall is measured @k")
    ap.add_argument("--queries", type=int, default=64,
                    help="held-out queries per trial")
    ap.add_argument("--seed", type=int, default=0, help="scan base seed")
    ap.add_argument("--workers", type=int, default=0,
                    help="worker processes (0/1 = inline)")
    ap.add_argument("--max-trials", type=int, default=None,
                    help="stop after this many NEW trials (resume later)")
    ap.add_argument("--device", default=None,
                    help="torch device of the trials; default the CUDA card (\"cpu\" runs "
                         "the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.tuner import TuningTable, build_table, run_scan, scan_is_complete

    space = build_space(args)
    trials = space.trials()
    store_path = os.path.join(args.out, "trials.jsonl")
    table_path = os.path.join(args.out, "tuning_table.json")
    print(f"scan space {space.space_id}: {len(trials)} trials -> {store_path}")

    records = run_scan(
        space, store_path, workers=args.workers,
        max_trials=args.max_trials, log=print, device=args.device,
    )
    if not scan_is_complete(space, store_path):
        remaining = len(trials) - len(records)
        print(
            f"PARTIAL: {len(records)}/{len(trials)} trials stored "
            f"({remaining} remaining) — rerun the same command to resume; "
            f"no table written"
        )
        return 0

    table = build_table(records, space)
    table.save(table_path)
    loaded = TuningTable.load(table_path)  # round-trip sanity
    n_entries = sum(len(b["entries"]) for b in loaded.buckets)
    print(
        f"tuning table: {len(loaded.buckets)} bucket(s), "
        f"{n_entries} frontier entries -> {table_path}"
    )
    for b in loaded.buckets:
        p = b["profile"]
        best = max(e["recall"] for e in b["entries"])
        print(
            f"  {b['family']:>6} n={p['n']} d={p['d']} skew={p['skew']}: "
            f"{len(b['entries'])} entries, best recall {best:.3f}"
        )
    print(json.dumps(loaded.provenance(), sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
