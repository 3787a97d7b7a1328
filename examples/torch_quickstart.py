"""Quickstart of the PyTorch port: sublinear NNS over generalized weighted
Manhattan distance through the ``repro_torch.api`` facade — QUALITY-FIRST.
The twin of ``examples/quickstart.py``, on the CUDA card by default.

    PYTHONPATH=src python examples/torch_quickstart.py [--n 50000]
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 2048

States a recall target (``QualitySpec``) and lets the planner derive both
the index geometry (family/K/L/W/window — Theorems 4/5 inverted on a data
sample) and the execution policy (probe vs multiprobe, calibrated on the
data). Then shows the mechanism path (``QuerySpec`` knobs), proves the two
meet bit-identically, round-trips the planned index through save/load, and
prints per-query diagnostics from ``Index.explain``. Data and queries come
from a seeded ``torch.Generator``.
"""

import argparse
import tempfile
import time

import torch

from repro_torch.api import Index, QualitySpec, QuerySpec
from repro_torch.api.index import resolve_device
from repro_torch.distance import recall_at_k


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=50_000)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n, d, k = args.n, 16, 10
    gen = torch.Generator().manual_seed(0)

    print(f"== dataset: n={n} d={d} on {device}")
    data = torch.rand((n, d), generator=gen).to(device)

    # --- say WHAT you need; the planner derives the HOW ---------------------
    quality = QualitySpec(k=k, recall_target=0.9, fail_prob=0.1)
    t0 = time.time()
    index = Index.build(1, data, quality, device=device)
    _sync(device)
    cfg = index.config
    print(f"== planned build in {time.time()-t0:.2f}s: family={cfg.family!r} "
          f"K={cfg.K} L={cfg.L} W={cfg.W:.3g} window={cfg.max_candidates} "
          f"(Thm 4/5 inverted on a {quality.calibration_queries}-point sample)")

    # --- weighted queries: weights arrive WITH the query (the paper's w) ----
    b = 64
    q = torch.rand((b, d), generator=gen).to(device)
    w = (torch.randn((b, d), generator=gen).abs() + 0.2).to(device)

    t0 = time.time()
    plan = index.plan(quality)  # memoized by the build's calibration
    print(f"== planned query in {time.time()-t0:.2f}s: mode={plan.mode!r} "
          f"n_probes={plan.n_probes} window={plan.max_candidates} "
          f"(calibrated recall {plan.predicted_recall:.2f}, "
          f"Thm 1 success bound {plan.predicted_success:.3f})")

    t0 = time.time()
    res = index.query(q, w, quality)  # resolves through the memoized plan
    _sync(device)
    t_alsh = time.time() - t0

    t0 = time.time()
    ref = index.query(q, w, QuerySpec(k=k, mode="exact"))
    _sync(device)
    t_bf = time.time() - t0

    cand = float(res.n_candidates.float().mean())
    recall = recall_at_k(res.ids, ref.ids, k)
    print(f"== ALSH:  {t_alsh*1e3:7.1f} ms for {b} queries  "
          f"(examined {cand:.0f}/{n} = {cand/n:.1%} candidates/query)")
    print(f"== exact: {t_bf*1e3:7.1f} ms for {b} queries  (100% scanned)")
    print(f"== measured recall@{k} = {recall:.2f} (target {quality.recall_target})")

    # --- the quality path IS the mechanism path — bit-identical -------------
    res_planned = index.query(q, w, plan)
    assert torch.equal(res.ids, res_planned.ids)
    assert torch.equal(res.dists, res_planned.dists)
    print("== query(QualitySpec) == query(resolved PlannedSpec), bit-identical")

    # explicit knobs still exist and still work (the paper's raw surface)
    res_knobs = index.query(q, w, plan.to_query_spec())
    print(f"== knob path: QuerySpec{(plan.to_query_spec().mode, plan.k)} "
          f"recall@{k} = {recall_at_k(res_knobs.ids, ref.ids, k):.2f}")

    # --- per-query diagnostics ----------------------------------------------
    report = index.explain(q, w, quality)
    print(f"== explain: mean predicted success "
          f"{float(report.predicted_success.mean()):.3f}, "
          f"{int((report.truncated_tables > 0).sum())}/{b} queries hit window "
          f"truncation, {int((report.n_invalid > 0).sum())}/{b} returned "
          f"sentinel slots")

    # --- self-describing persistence (plans travel too) ---------------------
    with tempfile.TemporaryDirectory() as ckdir:
        index.save(ckdir)
        restored = Index.load(ckdir, device=device)  # directory alone
        assert restored.plans == index.plans
        r2 = restored.query(q, w, quality)  # memo hit, no re-calibration
        assert torch.equal(r2.ids, res.ids)
        print(f"== save/load round-trip: restored index (n={restored.n}, "
              f"family={restored.config.family!r}, {len(restored.plans)} "
              f"memoized plan) answers bit-identically")

    # --- negative weights (paper abstract: each w_i may be < 0) -------------
    w_neg = torch.randn((b, d), generator=gen).to(device)
    res_neg = index.query(q, w_neg, plan)
    ref_neg = index.query(q, w_neg, QuerySpec(k=k, mode="exact"))
    print(f"== mixed-sign weights: recall@{k} = "
          f"{recall_at_k(res_neg.ids, ref_neg.ids, k):.2f} "
          f"(harder geometry: near = most-negative distance)")
    return recall


if __name__ == "__main__":
    main()
