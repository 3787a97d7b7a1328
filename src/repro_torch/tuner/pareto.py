"""Dominance filtering and the versioned ``tuning_table.json`` artifact —
counterpart of ``repro.tuner.pareto``, in the reference's format.

The scan's trial records are reduced per ``(family, data profile)`` bucket
to the recall/cost/memory Pareto frontier, the operating points no other
point beats on every axis at once; the Planner consults it as an empirical
prior.

Objectives (fixed, recorded in the artifact):

  * ``recall``     maximize — held-out recall@k against the exact oracle
  * ``cost``       minimize — the planner's deterministic candidate+slot
                   model (wall-clock-free, so the artifact is reproducible)
  * ``mem_bytes``  minimize — bytes of the built index state

The frontier is a pure function of the records' deterministic fields:
exact objective duplicates collapse to the smallest ``trial_id`` and the
entries sort by (recall desc, cost asc, trial_id). The file is JSON with
sorted keys and an indent of 2, so equal records give equal bytes in either
package and a table one package writes, the other reads.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os

__all__ = ["dominates", "pareto_front", "TuningTable", "build_table"]

TABLE_FORMAT = "repro.tuner.table"
TABLE_VERSION = 1

# (record key, sense): sense +1 = minimize, -1 = maximize
OBJECTIVES = (("recall", -1), ("cost", 1), ("mem_bytes", 1))

# fields copied from a trial record into a frontier entry — deterministic
# only (us_per_query is deliberately absent; see module docstring).
# early-exit knobs ride along so the planner prior can replay them;
# tables_probed is informational (the cost column already embeds it).
_ENTRY_FIELDS = (
    "trial_id", "family", "K", "L", "W", "n_probes", "max_flips",
    "window", "k", "shards", "recall", "cand_frac", "cost", "mem_bytes",
    "early_exit", "exit_group", "exit_slack", "tables_probed",
)

# defaults for records written before the early-exit axes existed
_ENTRY_DEFAULTS = {
    "early_exit": False, "exit_group": 0, "exit_slack": 0.0,
    "tables_probed": None,
}


def _objective_vector(rec: dict) -> tuple:
    """The record as a minimize-everything tuple."""
    return tuple(sense * float(rec[key]) for key, sense in OBJECTIVES)


def dominates(a: dict, b: dict) -> bool:
    """True when ``a`` is at least as good as ``b`` on every objective and
    strictly better on at least one (ties on every axis dominate nothing)."""
    va, vb = _objective_vector(a), _objective_vector(b)
    return all(x <= y for x, y in zip(va, vb)) and any(
        x < y for x, y in zip(va, vb)
    )


def pareto_front(records: list) -> list:
    """The non-dominated subset of ``records``, canonically ordered.

    Edge-case contract (tested):
      * a single record is its own frontier;
      * records tied on every objective (duplicate non-dominated trials)
        collapse to the one with the smallest ``trial_id``;
      * ties on SOME objectives dominate nothing — both survive.
    """
    # collapse exact objective duplicates first (dominance is irreflexive,
    # so without this both copies would survive and the artifact would
    # depend on store insertion order)
    by_vec: dict = {}
    for rec in records:
        if rec.get("status", "ok") != "ok":
            continue
        vec = _objective_vector(rec)
        best = by_vec.get(vec)
        if best is None or rec["trial_id"] < best["trial_id"]:
            by_vec[vec] = rec
    unique = list(by_vec.values())
    front = [
        r for r in unique if not any(dominates(o, r) for o in unique if o is not r)
    ]
    front.sort(key=lambda r: (-r["recall"], r["cost"], r["trial_id"]))
    return front


def _entry(rec: dict) -> dict:
    return {
        k: rec.get(k, _ENTRY_DEFAULTS[k]) if k in _ENTRY_DEFAULTS else rec[k]
        for k in _ENTRY_FIELDS
    }


@dataclasses.dataclass
class TuningTable:
    """The versioned Pareto-table artifact the Planner consults.

    ``buckets`` is a list of ``{family, profile: {n, d, skew, source},
    entries: [...]}`` dicts — one per (family, data profile) with at least
    one usable trial, entries being the canonical Pareto frontier. ``meta``
    records the provenance: scan space id, trial counts, the artifact
    version. Serialized with sorted keys, so the file is byte-stable.
    """

    buckets: list
    meta: dict

    # -- persistence --------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": TABLE_FORMAT,
            "version": TABLE_VERSION,
            "meta": self.meta,
            "buckets": self.buckets,
        }

    def save(self, path: str | os.PathLike) -> str:
        path = os.fspath(path)
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str | os.PathLike) -> "TuningTable":
        path = os.fspath(path)
        with open(path) as f:
            d = json.load(f)
        if d.get("format") != TABLE_FORMAT:
            raise ValueError(
                f"{path} has format {d.get('format')!r}, expected "
                f"{TABLE_FORMAT!r} — not a tuning table"
            )
        if d.get("version") != TABLE_VERSION:
            raise ValueError(
                f"{path} is tuning-table version {d.get('version')!r}; this "
                f"build reads version {TABLE_VERSION} — re-run the scan or "
                f"upgrade"
            )
        return cls(buckets=d["buckets"], meta=d.get("meta", {}))

    def provenance(self) -> dict:
        """The compact stamp shipped inside index manifests (see
        ``Index.save``): enough to trace a served plan back to the scan
        that justified it."""
        return {
            "format": TABLE_FORMAT,
            "version": TABLE_VERSION,
            "space_id": self.meta.get("space_id"),
            "n_trials": self.meta.get("n_trials"),
            "k": self.meta.get("k"),
        }

    # -- lookup -------------------------------------------------------------
    # bucket-match tolerances: a profile is "in bucket" within 2x on rows
    # (log2 distance <= 1) and 0.5 on weight skew; d must match exactly
    # (every knob's meaning changes with dimensionality)
    MAX_LOG2_N = 1.0
    MAX_SKEW = 0.5

    def nearest_bucket(
        self, family: str | None, n: int, d: int, skew: float = 1.0
    ) -> dict | None:
        """The closest scanned profile bucket, or None when the query
        profile is out of every bucket's tolerance box (the caller must
        then fall back to full calibration). ``family=None`` searches all
        families (build-time auto selection)."""
        best, best_key = None, None
        for b in self.buckets:
            if family is not None and b["family"] != family:
                continue
            p = b["profile"]
            if p["d"] != d:
                continue
            dn = abs(math.log2(max(n, 1)) - math.log2(max(p["n"], 1)))
            ds = abs(skew - p["skew"])
            if dn > self.MAX_LOG2_N or ds > self.MAX_SKEW:
                continue
            key = (dn + ds, p["n"], p["skew"], b["family"])
            if best_key is None or key < best_key:
                best, best_key = b, key
        return best

    @staticmethod
    def best_entry(bucket: dict, recall_target: float) -> dict | None:
        """Cheapest frontier entry meeting ``recall_target`` (None when the
        whole frontier falls short — the scanned grid never reached that
        recall on this profile)."""
        ok = [e for e in bucket["entries"] if e["recall"] >= recall_target - 1e-9]
        if not ok:
            return None
        return min(ok, key=lambda e: (e["cost"], e["trial_id"]))


def build_table(records: list, space) -> TuningTable:
    """Reduce scan records to the per-(family, profile) frontier table.

    Deterministic given the records' deterministic fields; trials with
    ``status != "ok"`` (e.g. skipped sharded trials) are excluded and
    counted in ``meta``.
    """
    groups: dict = {}
    n_ok = 0
    for rec in records:
        if rec.get("status", "ok") != "ok":
            continue
        n_ok += 1
        p = rec["trial"]["profile"]
        gk = (rec["family"], p["n"], p["d"], p["skew"], p["source"])
        groups.setdefault(gk, []).append(rec)
    buckets = []
    for gk in sorted(groups):
        family, n, d, skew, source = gk
        front = pareto_front(groups[gk])
        if not front:
            continue
        buckets.append({
            "family": family,
            "profile": {"n": n, "d": d, "skew": skew, "source": source},
            "entries": [_entry(r) for r in front],
        })
    return TuningTable(
        buckets=buckets,
        meta={
            "space_id": space.space_id,
            "k": space.k,
            "n_trials": len(records),
            "n_ok": n_ok,
            "objectives": [
                {"key": k, "sense": "max" if s < 0 else "min"}
                for k, s in OBJECTIVES
            ],
        },
    )
