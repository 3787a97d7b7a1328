"""The offline autotuner — counterpart of ``repro.tuner``.

  1. :mod:`repro_torch.tuner.space` — declare the scan: the five ALSH knobs
     (family × K × L × W × probes × window) crossed with data profiles.
     Trials are content-addressed and seeded from their own ids.
  2. :mod:`repro_torch.tuner.scan` — run it: inline or over a spawn pool of
     workers, each trial measuring held-out recall@k, candidate fraction
     and cost through the real query path on the card, recorded in a
     crash-safe JSONL store.
  3. :mod:`repro_torch.tuner.pareto` — reduce it: per-(family, profile)
     recall/cost/memory Pareto frontiers in the versioned
     ``tuning_table.json``.
  4. ``repro_torch.api.Planner(table=...)`` — consume it: a confirmed
     frontier plan replaces the calibration ladder (``provenance="prior"``).

Trial ids, space ids, stores and tables are the reference's, byte for byte.

CLI: ``python -m repro_torch.launch.tune``.
"""

from repro_torch.tuner.pareto import TuningTable, build_table, pareto_front
from repro_torch.tuner.scan import TrialStore, run_scan, run_trial, scan_is_complete
from repro_torch.tuner.space import (
    DataProfile,
    ScanSpace,
    TrialSpec,
    grid,
    log_range,
    seeded_choice,
)

__all__ = [
    "DataProfile",
    "ScanSpace",
    "TrialSpec",
    "grid",
    "log_range",
    "seeded_choice",
    "TrialStore",
    "run_scan",
    "run_trial",
    "scan_is_complete",
    "TuningTable",
    "build_table",
    "pareto_front",
]
