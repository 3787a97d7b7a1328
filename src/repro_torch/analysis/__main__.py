"""CLI of the static-contract gate — counterpart of ``python -m repro.analysis``.

    python -m repro_torch.analysis                     # lint + audit on the card, exit 0/1
    python -m repro_torch.analysis --device cpu        # the same on the CPU
    python -m repro_torch.analysis --lint-only
    python -m repro_torch.analysis --audit-only
    python -m repro_torch.analysis --write-golden      # regenerate the backend's golden
    python -m repro_torch.analysis --seed-regression memory   # must exit 1
    python -m repro_torch.analysis --seed-regression retrace  # must exit 1
    python -m repro_torch.analysis --report out.json

Like every entry point of the port, the audit runs on the CUDA card unless
``--device cpu`` is given; without a card it raises (no fallback). The
``--seed-regression`` modes test the gate itself: they splice a known-bad
pattern (the dense delta-match materialization, or an unfolded static
axis) into the audit, which MUST then fail with the named diagnostic.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--audit-only", action="store_true")
    ap.add_argument("--write-golden", action="store_true",
                    help="regenerate the backend's golden_budget_<backend>.json from this run")
    ap.add_argument("--seed-regression", choices=("memory", "retrace"),
                    help="inject a known-bad pattern; the audit must fail")
    ap.add_argument("--report", type=Path, default=Path("analysis_report.json"),
                    help="where to write the JSON report (audit runs only)")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="lint these paths instead of src/repro_torch")
    ap.add_argument("--device", default=None,
                    help="device of the audit (default: the CUDA card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parents[2]  # .../src
    rc = 0

    if not args.audit_only:
        from repro_torch.analysis.lint import lint_paths

        paths = args.paths or [str(root / "repro_torch")]
        findings = lint_paths(paths, root=str(root))
        for f in findings:
            print(f)
        print(f"lint: {len(findings)} finding(s)")
        if findings:
            rc = 1

    if not args.lint_only:
        from repro_torch.analysis import audit, budgets
        from repro_torch.api.index import resolve_device

        backend = resolve_device(args.device).type
        golden = None if (args.write_golden or args.seed_regression) else (
            audit.load_golden(backend)
        )
        report = audit.run_audit(
            inject=args.seed_regression,
            golden=golden,
            live_probe=args.seed_regression is None,
            device=args.device,
        )
        args.report.write_text(json.dumps(report, indent=2) + "\n")
        ck = report["compile_keys"]
        mem = report["memory"]
        print(
            f"audit ({report['backend']}): {ck['raw_points']} raw lattice points -> "
            f"{ck['count']} compile keys (budget {ck['budget']}); "
            f"worst path {mem['worst_path']} peaks at "
            f"{mem['max_peak_live_bytes'] / 2**20:.1f} MiB "
            f"(envelope {mem['envelope_bytes'] / 2**20:.0f} MiB)"
        )
        for f in report["failures"]:
            print(
                f"{f['code']} {f['path']}: {f['message']} "
                f"(measured {f['measured']:g} vs budget {f['budget']:g})"
            )
        if args.write_golden:
            path = budgets.GOLDEN_PATHS[report["backend"]]
            path.write_text(
                json.dumps(audit.golden_from_report(report), indent=2,
                           sort_keys=True) + "\n"
            )
            print(f"golden written: {path}")
        if not report["ok"]:
            rc = 1
        print(f"audit: {'ok' if report['ok'] else 'FAILED'} "
              f"({len(report['failures'])} failure(s))")

    return rc


if __name__ == "__main__":
    sys.exit(main())
