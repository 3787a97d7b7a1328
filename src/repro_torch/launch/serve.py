"""Serving launcher — the ALSH vector-search service on the GPU.

Counterpart of ``repro.launch.serve``:

  * ``--mode alsh``: build the index over n uniform rows (stored as
    ``--storage``), then serve query batches in single-probe or
    ``--multiprobe`` mode — on a quantized table with the proxy screen at
    ``--screen-alpha``, and with ``--early-exit`` through the streamed
    early-exit tail (``--exit-group`` windows per group, ``--exit-slack``
    miss budget) — and spot-check recall against the exact scan on the
    first 16 queries of each batch; ``--stats`` adds the storage-tier
    accounting and, for a streamed query, the windows probed and the mix of
    stop reasons (``Index.explain`` on those 16 queries). With
    ``--recall-target R`` (and optionally ``--latency-budget-ms B``) the
    configuration is quality first: the index is built from
    ``QualitySpec(k=--topk, recall_target=R, latency_budget_ms=B)`` (the
    planner derives family, K, L, W and the window; ``--K``/``--L``/
    ``--multiprobe``/``--probes``/``--storage`` are then ignored), the
    resolved plan is printed and served, and each batch line adds the
    predicted success and the truncated windows of its first 16 queries;
  * ``--mode stream``: the mutable-index service. Build the f32 index with
    ``UpdateSpec(delta_capacity=--delta-capacity,
    compact_threshold=--compact-threshold)``, then per tick insert
    ``--ingest`` rows, retire the ``--retire`` oldest main rows (FIFO),
    serve one query batch over both segments, spot-check recall against
    exact mode on 16 queries, and compact when ``needs_compact``.

The printed lines match the reference's.

    python -m repro_torch.launch.serve --mode alsh [--n 262144 --d 128 --batches 3]
    python -m repro_torch.launch.serve --mode alsh --device cpu --n 4096 --d 16
    python -m repro_torch.launch.serve --mode alsh --storage int8 --screen-alpha 2 \
        --multiprobe --probes 8
    python -m repro_torch.launch.serve --mode alsh --device cpu --n 4096 --d 16 \
        --early-exit --stats
    python -m repro_torch.launch.serve --mode stream --n 262144 --d 128 --query-batch 1024
    python -m repro_torch.launch.serve --mode alsh --n 262144 --d 128 --query-batch 1024 \
        --recall-target 0.9
    python -m repro_torch.launch.serve --mode alsh --device cpu --n 4096 --d 16 \
        --query-batch 64 --recall-target 0.9 --latency-budget-ms 1

The data and queries come from a seeded ``torch.Generator`` (the reference
draws them with ``jax.random``, so the two services see different data).
The other modes raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import not_ported

UNPORTED_MODES = {
    "broker": "Queue A item 11",
    "lm": "Queue A item 14",
}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_alsh(args):
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.api import Index, QualitySpec, QuerySpec
    from repro_torch.api.index import resolve_device
    from repro_torch.configs.paper_alsh import ALSHServiceConfig
    from repro_torch.distance import recall_at_k

    device = resolve_device(args.device)
    svc = ALSHServiceConfig(
        n_per_shard=args.n, d=args.d, K=args.K, L=args.L,
        query_batch=args.query_batch, topk=args.topk,
    )
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((svc.n_per_shard, svc.d), generator=gen).to(device)
    # quality-first: a stated recall target plans BOTH the geometry and the
    # serving policy; explicit knobs skip planning entirely
    quality = None
    if args.recall_target is not None:
        quality = QualitySpec(k=svc.topk, recall_target=args.recall_target,
                              latency_budget_ms=args.latency_budget_ms)
        build_cfg = quality
    else:
        build_cfg = dataclasses.replace(svc.index_config, storage=args.storage)
    t0 = time.time()
    index = Index.build(2, data, build_cfg, device=device)
    _sync(device)
    cfg = index.config
    print(f"[alsh] built index over n={svc.n_per_shard} d={svc.d} "
          f"family={cfg.family} K={cfg.K} L={cfg.L} storage={cfg.storage} "
          f"in {time.time()-t0:.2f}s"
          + (" (planned from QualitySpec)" if quality is not None else ""))

    # serving policy is a spec value, not a code path
    if quality is not None:
        t0 = time.time()
        spec = index.plan(quality)  # memoized by the build's calibration
        print(f"[alsh] planned in {time.time()-t0:.2f}s: {spec}")
    elif args.multiprobe:
        spec = QuerySpec(k=svc.topk, mode="multiprobe", n_probes=args.probes)
    else:
        spec = QuerySpec(k=svc.topk)
    if cfg.storage != "f32" and spec.mode != "exact" and spec.screen_alpha == 0.0:
        # quantized tier: screen against compressed rows, exact-rerank the
        # top k*alpha survivors
        spec = dataclasses.replace(spec, screen_alpha=args.screen_alpha)
    if args.early_exit and spec.mode != "exact" and spec.screen_alpha == 0.0:
        # adaptive probing: stream probe windows, stop per query once the
        # running top-k clears the confidence bound
        spec = dataclasses.replace(spec, early_exit=True, exit_group=args.exit_group,
                                   exit_slack=args.exit_slack)
    exact = QuerySpec(k=svc.topk, mode="exact")
    print(f"[alsh] serving policy: {spec}")

    for b in range(args.batches):
        q = torch.rand((svc.query_batch, svc.d), generator=gen).to(device)
        w = (torch.randn((svc.query_batch, svc.d), generator=gen).abs() + 0.1).to(device)
        t0 = time.time()
        res = index.query(q, w, spec)
        _sync(device)
        dt = time.time() - t0
        # spot-check recall on the first 16 queries (exact mode = the oracle)
        ref = index.query(q[:16], w[:16], exact)
        rec = recall_at_k(res.ids[:16], ref.ids, svc.topk)
        cand_frac = float(res.n_candidates.float().mean()) / svc.n_per_shard
        line = (f"[alsh] batch {b}: {svc.query_batch} queries in {dt*1e3:.1f} ms "
                f"({dt/svc.query_batch*1e6:.1f} us/query) "
                f"cand_frac={cand_frac:.4f} "
                f"recall@{svc.topk}~{rec:.2f}")
        if quality is not None:
            # per-query diagnostics: predicted success + truncation pressure
            rep = index.explain(q[:16], w[:16], spec)
            line += (f" pred_success~{float(rep.predicted_success.mean()):.2f} "
                     f"truncated={int((rep.truncated_tables > 0).sum())}/16")
        print(line)
        if args.stats:
            # storage-tier accounting: bytes moved by the gather tail
            rep = index.explain(q[:16], w[:16], spec)
            print(f"[alsh]   stats: storage={rep.storage} "
                  f"table_bytes={rep.table_bytes} "
                  f"rows_screened~{float(np.mean(rep.rows_screened)):.1f} "
                  f"rows_reranked~{float(np.mean(rep.rows_reranked)):.1f} "
                  f"bytes_gathered~{float(np.mean(rep.bytes_gathered)):.0f}")
            if rep.tables_probed is not None:
                # adaptive-probing accounting: windows visited + stop mix
                d = rep.to_dict()
                n_win = cfg.L * (spec.n_probes if spec.mode == "multiprobe" else 1)
                print(f"[alsh]   stats: tables_probed~"
                      f"{d['mean_tables_probed']:.1f}/{n_win} "
                      f"stop_reasons={d['stop_reasons']}")


def serve_alsh_stream(args):
    """Mutable-index service: rows arrive and retire while queries flow."""
    import torch

    from repro_torch.api import Index, QuerySpec, UpdateSpec
    from repro_torch.api.index import resolve_device
    from repro_torch.configs.paper_alsh import ALSHServiceConfig
    from repro_torch.distance import recall_at_k

    device = resolve_device(args.device)
    svc = ALSHServiceConfig(
        n_per_shard=args.n, d=args.d, K=args.K, L=args.L,
        query_batch=args.query_batch, topk=args.topk,
    )
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((svc.n_per_shard, svc.d), generator=gen).to(device)
    update = UpdateSpec(delta_capacity=args.delta_capacity,
                        compact_threshold=args.compact_threshold)
    t0 = time.time()
    index = Index.build(2, data, svc.index_config, update=update, device=device)
    _sync(device)
    print(f"[stream] built mutable index n={svc.n_per_shard} d={svc.d} "
          f"delta_capacity={args.delta_capacity} in {time.time()-t0:.2f}s")

    spec = QuerySpec(k=svc.topk)
    exact = QuerySpec(k=svc.topk, mode="exact")
    next_retire = 0  # retire oldest main rows first (FIFO churn)
    for b in range(args.batches):
        # ingest: new rows enter the delta segment
        rows = torch.rand((args.ingest, svc.d), generator=gen).to(device)
        t0 = time.time()
        index, ids = index.insert(rows)
        _sync(device)
        t_ins = time.time() - t0
        # retire: the oldest rows tombstone out
        retire = torch.arange(next_retire, next_retire + args.retire, dtype=torch.int32,
                              device=device)
        next_retire += args.retire
        index = index.delete(retire)
        # serve queries against the live two-segment view
        q = torch.rand((svc.query_batch, svc.d), generator=gen).to(device)
        w = (torch.randn((svc.query_batch, svc.d), generator=gen).abs() + 0.1).to(device)
        t0 = time.time()
        res = index.query(q, w, spec)
        _sync(device)
        t_q = time.time() - t0
        ref = index.query(q[:16], w[:16], exact)
        rec = recall_at_k(res.ids[:16], ref.ids, svc.topk)
        fill = index.delta_fill
        print(f"[stream] tick {b}: +{args.ingest} rows in {t_ins*1e3:.1f} ms "
              f"({args.ingest/max(t_ins,1e-9):,.0f} rows/s), -{args.retire} retired, "
              f"{svc.query_batch} queries in {t_q*1e3:.1f} ms "
              f"({t_q/svc.query_batch*1e6:.1f} us/query) "
              f"delta={fill}/{args.delta_capacity} recall@{svc.topk}~{rec:.2f}")
        if index.needs_compact:
            t0 = time.time()
            index = index.compact()
            _sync(device)
            # compact renumbers survivors to [0, n_live); everything below
            # next_retire was tombstoned, so the oldest surviving row is 0
            next_retire = 0
            print(f"[stream] compacted to n={index.n} (delta emptied) "
                  f"in {time.time()-t0:.2f}s")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["alsh", "stream", "broker", "lm"], default="alsh")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the "
                         "plain PyTorch path)")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--K", type=int, default=12)
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--query-batch", type=int, default=256)
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--storage", choices=["f32", "bf16", "int8"], default="f32",
                    help="compressed table tier (quantized rows are screened then "
                         "exact-reranked)")
    ap.add_argument("--screen-alpha", type=float, default=2.0,
                    help="keep k*alpha proxy-screen survivors for exact rerank "
                         "(quantized storage only)")
    ap.add_argument("--stats", action="store_true",
                    help="alsh mode: print storage-tier accounting (table_bytes, rows "
                         "screened/reranked, bytes gathered) and, with --early-exit, the "
                         "windows probed and the stop reasons, per batch")
    ap.add_argument("--early-exit", action="store_true",
                    help="alsh mode: adaptive probing — stream probe windows in groups and "
                         "stop per query at the confidence bound (folds off under an active "
                         "quantized screen)")
    ap.add_argument("--exit-group", type=int, default=8,
                    help="alsh mode: probe windows per streamed group (with --early-exit)")
    ap.add_argument("--exit-slack", type=float, default=0.1,
                    help="alsh mode: acceptable miss probability for the confidence stop; "
                         "0 disables it (geometric-only, bit-identical results)")
    ap.add_argument("--multiprobe", action="store_true",
                    help="serve with QuerySpec(mode='multiprobe')")
    ap.add_argument("--probes", type=int, default=8, help="multiprobe buckets per table")
    ap.add_argument("--recall-target", type=float, default=None,
                    help="alsh mode: quality-first serving — plan geometry and policy for "
                         "this recall@topk (overrides --K/--L/--multiprobe/--probes/--storage)")
    ap.add_argument("--latency-budget-ms", type=float, default=None,
                    help="alsh mode: optional per-query latency budget for the planner's "
                         "cost model (with --recall-target)")
    ap.add_argument("--ingest", type=int, default=512,
                    help="stream mode: rows inserted per tick")
    ap.add_argument("--retire", type=int, default=128,
                    help="stream mode: oldest rows deleted per tick")
    ap.add_argument("--delta-capacity", type=int, default=8192,
                    help="stream mode: delta segment slots (UpdateSpec.delta_capacity)")
    ap.add_argument("--compact-threshold", type=float, default=0.75,
                    help="stream mode: delta fill fraction that triggers compact()")
    args = ap.parse_args(argv)
    if args.mode == "stream":
        serve_alsh_stream(args)
    elif args.mode == "alsh":
        serve_alsh(args)
    else:
        raise not_ported(f"--mode {args.mode}", UNPORTED_MODES[args.mode])


if __name__ == "__main__":
    main()
