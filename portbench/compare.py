"""The comparison that decides ``correct``: what the timed path answered,
held against the plain reference.

Numbers, each held to a limit from ``limits/<cell>.json``:

* ``dist_gap``: the largest relative gap between a returned distance and
  the float64 distance of the returned row (arithmetic of the re-rank or
  the scan); an id that names no row, or a distance that does not match
  its id's validity, reads inf;
* ``top10_miss``: the share of queries whose answer is not the reference's
  k nearest: some rank's float64 distance of the returned row departs from
  the reference's distance at that rank by more than ``RANK_RTOL`` of it,
  or the answer repeats a row. Rows that tie within float32 rounding may
  swap places;
* ``ncand_gap`` (probe and multiprobe): the mean over queries of the
  relative difference between the count of distinct candidates that
  ``query`` returns and the reference's: the query hash keys, the window
  probe and the dedupe, seen through what ``query`` returns. A float32
  projection within rounding of 0 flips a row's bit now and then, which
  moves one row of a window in every query that probes its bucket, so
  sound runs read small but not 0; a wrong key or window moves whole
  windows.

Every answer of the window counts, with the repeats of one pool batch
counted as often as they came.
"""

from __future__ import annotations

import torch

# f32 rounding of a sum of d <= 960 non-negative terms moves it by at most
# d·2^-24 ≈ 5.7e-5 of itself; two rows whose distances lie closer than that
# may come in either order.
RANK_RTOL = 1e-4


def judge_answer(ids, dists, ncand, d64, ref_d, ref_count, n):
    """Per-query verdicts of one answer: (miss (b,) bool, gap (b,) f64,
    relative candidate-count gap (b,) f64 or None). ``d64`` is the float64 distance of each
    returned id (inf for -1), ``ref_d`` the reference's k distances."""
    ids = ids.long()
    valid = ids >= 0
    bad = (ids < -1) | (ids >= n) | (valid != torch.isfinite(dists))
    gap = torch.where(valid, (dists.double() - d64).abs() / d64.clamp_min(1e-300),
                      torch.zeros_like(d64))
    gap = torch.where(bad, torch.full_like(gap, float("inf")), gap)
    both_inf = torch.isinf(d64) & torch.isinf(ref_d)
    close = (d64 - ref_d).abs() <= RANK_RTOL * ref_d
    rank_ok = both_inf | close
    srt = torch.sort(torch.where(valid, ids, torch.full_like(ids, -1)), dim=1).values
    repeat = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any(dim=1)
    miss = (~rank_ok).any(dim=1) | repeat | bad.any(dim=1)
    ngap = None if ref_count is None else (
        (ncand.double() - ref_count.double()).abs() / ref_count.double().clamp_min(1.0))
    return miss, gap.max(dim=1).values, ngap


class Tally:
    """Running sums of the numbers over the answers judged."""

    def __init__(self, with_ncand: bool):
        self.queries = 0
        self.miss = 0
        self.gap = 0.0
        self.ngap = 0.0 if with_ncand else None

    def add(self, miss, gap, ngap, times: int = 1):
        self.queries += times * miss.numel()
        self.miss += times * int(miss.sum())
        self.gap = max(self.gap, float(gap.max()) if gap.numel() else 0.0)
        if self.ngap is not None:
            self.ngap += times * float(ngap.sum())

    def numbers(self) -> dict:
        out = {"dist_gap": self.gap, "top10_miss": self.miss / max(self.queries, 1)}
        if self.ngap is not None:
            out["ncand_gap"] = self.ngap / max(self.queries, 1)
        return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and every limit's number present."""
    checks = {name: {"value": numbers.get(name), "limit": limit} for name, limit in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
