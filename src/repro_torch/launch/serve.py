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
    exact mode on 16 queries, and compact when ``needs_compact``;
  * ``--mode broker``: the fault-tolerant serving drill. Build from
    ``QualitySpec(k=--topk, recall_target=--recall-target or 0.9)``, print
    the degradation ladder, optionally split the index into ``--shards``
    persisted shards with ``--kill-shard`` killed at virtual time
    ``--kill-at``, then serve a ``--arrival`` trace of ``--requests``
    requests at ``--rate`` through the ``Broker`` (``--slo-p99-ms``,
    ``--max-batch``, ``--max-queue``), assert no kernel was built after
    warmup, print the latency, shedding and degradation figures and, for a
    chaos run, assert the labeled coverage loss and the recovery;
  * ``--mode lm``: LM serving. Build ``--arch`` (``--reduced`` for the tiny
    smoke dimensions) with random parameters, prefill a batch of ``--batch``
    random prompts of ``--prompt-len`` tokens, then decode ``--gen-len``
    tokens greedily — with ``--retrieval`` through the ALSH kNN-LM
    attachment over a datastore of 4096 records (d_key 16, K=6, L=8,
    top-4), as the reference's. Only the dense architectures run; the
    others raise ``NotImplementedError`` naming their ROADMAP.md item.

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
    python -m repro_torch.launch.serve --mode broker --device cpu --n 4096 --d 16 \
        --shards 4 --kill-shard 1
    python -m repro_torch.launch.serve --mode lm --retrieval     # full-width gemma3-1b
    python -m repro_torch.launch.serve --mode lm --device cpu --reduced --retrieval \
        --batch 2 --prompt-len 16 --gen-len 4

The data, queries, parameters and prompts come from seeded
``torch.Generator``s (the reference draws them with ``jax.random``, so the
two services see different data).
"""

from __future__ import annotations

import argparse
import time


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


def serve_broker(args):
    """Fault-tolerant broker drill: arrival trace -> batched queries under
    an SLO, with an optional scripted shard failure."""
    import tempfile

    import torch

    from repro_torch.api import Index, QualitySpec
    from repro_torch.api.index import resolve_device
    from repro_torch.serving import (
        Broker,
        BrokerConfig,
        ChaosPlan,
        ShardSet,
        SLOConfig,
        make_trace,
        requests_from_trace,
    )

    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((args.n, args.d), generator=gen).to(device)
    quality = QualitySpec(
        k=args.topk,
        recall_target=args.recall_target if args.recall_target is not None else 0.9,
    )
    t0 = time.time()
    index = Index.build(2, data, quality, device=device)
    ladder = index.plan_ladder(quality)
    _sync(device)
    print(f"[broker] built+planned n={args.n} d={args.d} in {time.time()-t0:.2f}s; "
          f"ladder has {len(ladder)} rungs "
          f"(recalls {[round(float(r.predicted_recall), 3) for r in ladder]})")

    shardset = None
    tmp = None
    if args.shards > 1:
        tmp = tempfile.TemporaryDirectory(prefix="repro_torch_shards_")
        t0 = time.time()
        shardset = ShardSet.build(index, args.shards, tmp.name)
        print(f"[broker] built {args.shards} shards (persisted for recovery) "
              f"in {time.time()-t0:.2f}s")
        if args.kill_shard is not None:
            shardset.chaos = ChaosPlan(kill_shard=args.kill_shard, kill_at_s=args.kill_at)
            print(f"[broker] chaos armed: kill shard {args.kill_shard} "
                  f"at t={args.kill_at}s")

    slo = SLOConfig(p99_ms=args.slo_p99_ms)
    broker = Broker(
        index, quality, slo,
        BrokerConfig(max_batch=args.max_batch, max_queue=args.max_queue),
        shardset=shardset,
    )
    q = torch.rand((256, args.d), generator=gen).numpy()
    w = (torch.randn((256, args.d), generator=gen).abs() + 0.1).numpy()
    trace = make_trace(args.arrival, args.rate, args.requests, seed=0)
    reqs = requests_from_trace(trace, q, w)
    t0 = time.time()
    responses, stats = broker.run(reqs)
    broker.assert_no_retrace()
    print(f"[broker] {args.arrival} trace: {len(reqs)} requests at ~{args.rate}/s "
          f"served in {time.time()-t0:.2f}s wall")
    print(f"[broker] p50={stats.p50_ms:.2f}ms p99={stats.p99_ms:.2f}ms "
          f"(SLO {slo.p99_ms}ms) throughput={stats.throughput_rps:.0f} req/s")
    print(f"[broker] shed_rate={stats.shed_rate:.3f} "
          f"degraded_frac={stats.degraded_frac:.3f} rungs={stats.rung_counts} "
          f"mean_coverage={stats.mean_coverage:.3f}")
    if shardset is not None and args.kill_shard is not None:
        served = [r for r in responses if r.status != "shed"]
        covs = sorted({round(r.coverage, 6) for r in served})
        expect = (args.shards - 1) / args.shards
        events = [e["event"] for e in shardset.recovery_log]
        print(f"[broker] chaos: coverages seen {covs}; recovery log events {events}")
        assert any(abs(c - expect) < 1e-9 for c in covs), (
            f"expected some survivors-only answers at coverage {expect}, got {covs}"
        )
        assert "killed" in events, "scripted kill never fired"
        assert "recovered" in events, "shard never recovered within the trace"
        assert shardset.coverage == 1.0, "shard set did not return to full coverage"
        print("[broker] chaos assertions passed: labeled degraded coverage + recovery")
    if tmp is not None:
        tmp.cleanup()
    return responses, stats


def serve_lm(args):
    import torch

    from repro_torch import models
    from repro_torch.api.index import resolve_device
    from repro_torch.configs import RetrievalConfig, get_bundle, reduced_model
    from repro_torch.runtime import retrieval as rt
    from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step

    device = resolve_device(args.device)
    bundle = get_bundle(args.arch)
    mcfg = reduced_model(bundle.model) if args.reduced else bundle.model
    rcfg = None
    if args.retrieval:
        rcfg = RetrievalConfig(datastore_size=4096, d_key=16, K=6, L=8, topk=4)

    params = models.init_params(0, mcfg, device=device)
    B, S, gen = args.batch, args.prompt_len, args.gen_len
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, mcfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
    prompt = prompt.to(device)

    prefill = make_prefill_step(mcfg, cache_len=S + gen)
    decode = make_decode_step(mcfg, rcfg)
    retr_state = None
    if rcfg is not None:
        retr_state = rt.build_datastore(2, mcfg.d_model, mcfg.vocab_size, rcfg, device=device)

    _sync(device)
    t0 = time.time()
    logits, caches = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    _sync(device)
    print(f"[lm] prefill B={B} S={S} in {time.time()-t0:.2f}s "
          f"(retrieval={'on' if rcfg else 'off'})")

    out = [tok]
    t0 = time.time()
    for i in range(gen):
        batch = {"token": tok, "pos": torch.full((B,), S + i, dtype=torch.int32, device=device)}
        if rcfg is None:
            _, tok, caches = decode(params, batch, caches)
        else:
            _, tok, caches = decode(params, batch, caches, retr_state)
        out.append(tok)
    _sync(device)
    dt = time.time() - t0
    print(f"[lm] generated {gen} tokens x {B} seqs in {dt:.2f}s "
          f"({dt/gen*1e3:.1f} ms/step); sample: {[int(t[0]) for t in out[:8]]}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["alsh", "stream", "broker", "lm"], default="alsh")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the "
                         "plain PyTorch path)")
    ap.add_argument("--arch", default="gemma3-1b", help="lm mode: the architecture")
    ap.add_argument("--reduced", action="store_true",
                    help="lm mode: the architecture's tiny smoke dimensions")
    ap.add_argument("--retrieval", action="store_true",
                    help="lm mode: decode through the ALSH kNN-LM attachment")
    ap.add_argument("--batch", type=int, default=4, help="lm mode: sequences")
    ap.add_argument("--prompt-len", type=int, default=64, help="lm mode: prompt tokens")
    ap.add_argument("--gen-len", type=int, default=16, help="lm mode: tokens generated")
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
                         "this recall@topk (overrides --K/--L/--multiprobe/--probes/--storage); "
                         "broker mode: the QualitySpec's target (default 0.9)")
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
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="broker mode: target p99 latency; breaches walk down the "
                         "degradation ladder")
    ap.add_argument("--arrival", choices=["poisson", "bursty"], default="poisson",
                    help="broker mode: arrival trace shape")
    ap.add_argument("--rate", type=float, default=500.0,
                    help="broker mode: mean arrival rate (req/s)")
    ap.add_argument("--requests", type=int, default=1000,
                    help="broker mode: trace length")
    ap.add_argument("--shards", type=int, default=1,
                    help="broker mode: >1 serves a host-side ShardSet")
    ap.add_argument("--kill-shard", type=int, default=None,
                    help="broker mode: chaos — shard to kill mid-stream (needs --shards > 1)")
    ap.add_argument("--kill-at", type=float, default=0.5,
                    help="broker mode: virtual time (s) of the shard kill")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="broker mode: largest dynamic-batch bucket")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="broker mode: admission queue bound (overflow sheds)")
    args = ap.parse_args(argv)
    if args.mode == "stream":
        serve_alsh_stream(args)
    elif args.mode == "alsh":
        serve_alsh(args)
    elif args.mode == "broker":
        return serve_broker(args)
    else:
        serve_lm(args)


if __name__ == "__main__":
    main()
