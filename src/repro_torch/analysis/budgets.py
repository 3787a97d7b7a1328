"""Declared static-contract budgets — counterpart of
``repro.analysis.budgets``, with the reference's geometry and lattice.

The audit (:mod:`repro_torch.analysis.audit`) runs the public query
entry-point lattice at the AUDIT geometry below and checks three budgets:

  * **retrace budget** — the compile-key cardinality of the whole lattice
    after :func:`repro_torch.engine.pipeline.normalize_static_args`. The
    raw lattice carries the redundant static axes callers may pass, and the
    normalization must fold them back to exactly ``RETRACE_BUDGET``
    distinct programs (the count a CUDA-graph capture per program would
    pay).
  * **memory envelope** — the peak live bytes of the tensors the aten ops
    of one path return (inputs the caller holds are not charged) must stay
    under ``MEMORY_ENVELOPE_BYTES``: the reference's 32 MiB. The port's
    worst legitimate path stays under half of it on both backends (the
    goldens), while the ``(b, L·P·C, cap)`` dense delta match this gate
    exists for costs 64 MiB at probe and 512 MiB at multiprobe p8.
  * **dtype contract** — no float64 tensor enters or leaves any op, and an
    int8 tensor may only go into the movement and decode ops of
    ``INT8_ALLOWED_OPS``: arithmetic on int8 means a quantized table is
    computed on outside the gather's decode.

Per-path measurements are diffed against the golden of their backend
(``golden_budget_cpu.json``, ``golden_budget_cuda.json``; regenerate with
``python -m repro_torch.analysis --device cpu --write-golden``, or on the
card without ``--device``) with ``GOLDEN_REL_TOL`` slack.
"""

from __future__ import annotations

from pathlib import Path

# The reference's audit geometry: four index builds take about a second,
# and the shapes that matter (candidate blocks, the delta match, the screen's
# survivors) are the real ones. ``delta_capacity`` is the 4096-row delta.
AUDIT_GEOMETRY = {
    "n": 4096,
    "d": 16,
    "M": 32,
    "K": 4,
    "L": 8,
    "W": 4.0,
    "max_candidates": 64,
    "delta_capacity": 4096,
    "b": 8,  # query batch rows per point
    "k": 10,
}

# Distinct programs of the audited lattice (exact: the lattice is fixed).
# As in the reference, 146 raw caller combinations fold to 64. The port has
# no program cache yet, so this count is computed (the normalized statics of
# a fixed list of points, beside a shape signature the audit indexes fix),
# not observed; it becomes a measurement once a CUDA-graph cache keys on it.
RETRACE_BUDGET = 64

# Peak live bytes of one path's op outputs. The reference's envelope; the
# port's worst path is far under it (golden files), and the dense delta
# match of a segmented probe path (64 MiB) breaches it twice over.
MEMORY_ENVELOPE_BYTES = 32 * 2**20

# Relative tolerance of the per-path golden diff.
GOLDEN_REL_TOL = 0.10

GOLDEN_PATHS = {
    "cpu": Path(__file__).with_name("golden_budget_cpu.json"),
    "cuda": Path(__file__).with_name("golden_budget_cuda.json"),
}

# The aten ops (``OpOverloadPacket`` names) an int8 tensor may go into on the
# lattice: the quantized table is MOVED (indexed, selected) and DECODED
# (``_to_copy``, the widening to f32) — never computed on. These are the ops
# the lattice's int8 paths use (the plain gathers on the CPU; only the exact
# mode's decode on the card, where the stored-type gathers take int8 rows
# through ``ctypes``, which the dispatch mode does not see — the report lists
# the kernels each int8 path launched). ``index_select`` is the movement of
# an explicit row selection.
INT8_ALLOWED_OPS = frozenset(
    {
        "_to_copy",  # the decode (widen to f32)
        "index",
        "index_select",
        "where",  # the two-segment owner select moves encoded rows
    }
)
