"""Serving launcher — the ALSH vector-search service on the GPU.

Counterpart of ``repro.launch.serve`` in ``--mode alsh`` on the explicit-knob
path: build the index over n uniform rows (stored as ``--storage``), then
serve query batches in single-probe or ``--multiprobe`` mode — on a
quantized table with the proxy screen at ``--screen-alpha`` — and
spot-check recall against the exact scan on the first 16 queries of each
batch. The printed lines match the reference's.

    python -m repro_torch.launch.serve --mode alsh [--n 262144 --d 128 --batches 3]
    python -m repro_torch.launch.serve --mode alsh --device cpu --n 4096 --d 16
    python -m repro_torch.launch.serve --mode alsh --storage int8 --screen-alpha 2 \
        --multiprobe --probes 8

The data and queries come from a seeded ``torch.Generator`` (the reference
draws them with ``jax.random``, so the two services see different data).
The other modes and the flags of unported features (``--stats``,
``--early-exit``, ``--recall-target``) raise ``NotImplementedError`` naming
their ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import not_ported

UNPORTED_MODES = {
    "stream": "Queue A item 7",
    "broker": "Queue A item 11",
    "lm": "Queue A item 14",
}


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve_alsh(args):
    import dataclasses

    import torch

    from repro_torch.api import Index, QuerySpec
    from repro_torch.api.index import resolve_device
    from repro_torch.configs.paper_alsh import ALSHServiceConfig
    from repro_torch.distance import recall_at_k

    if args.recall_target is not None:
        raise not_ported("--recall-target (quality-first planning)", "Queue A item 10")
    if args.early_exit:
        raise not_ported("--early-exit", "Queue A item 8")
    if args.stats:
        raise not_ported("--stats (explain/QueryReport)", "Queue A item 9")

    device = resolve_device(args.device)
    svc = ALSHServiceConfig(
        n_per_shard=args.n, d=args.d, K=args.K, L=args.L,
        query_batch=args.query_batch, topk=args.topk,
    )
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((svc.n_per_shard, svc.d), generator=gen).to(device)
    cfg = dataclasses.replace(svc.index_config, storage=args.storage)
    t0 = time.time()
    index = Index.build(2, data, cfg, device=device)
    _sync(device)
    print(f"[alsh] built index over n={svc.n_per_shard} d={svc.d} "
          f"family={cfg.family} K={cfg.K} L={cfg.L} storage={cfg.storage} "
          f"in {time.time()-t0:.2f}s")

    # serving policy is a spec value, not a code path
    if args.multiprobe:
        spec = QuerySpec(k=svc.topk, mode="multiprobe", n_probes=args.probes)
    else:
        spec = QuerySpec(k=svc.topk)
    if cfg.storage != "f32" and spec.mode != "exact" and spec.screen_alpha == 0.0:
        # quantized tier: screen against compressed rows, exact-rerank the
        # top k*alpha survivors
        spec = dataclasses.replace(spec, screen_alpha=args.screen_alpha)
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
        print(f"[alsh] batch {b}: {svc.query_batch} queries in {dt*1e3:.1f} ms "
              f"({dt/svc.query_batch*1e6:.1f} us/query) "
              f"cand_frac={cand_frac:.4f} "
              f"recall@{svc.topk}~{rec:.2f}")


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
    ap.add_argument("--stats", action="store_true", help="not ported")
    ap.add_argument("--early-exit", action="store_true", help="not ported")
    ap.add_argument("--multiprobe", action="store_true",
                    help="serve with QuerySpec(mode='multiprobe')")
    ap.add_argument("--probes", type=int, default=8, help="multiprobe buckets per table")
    ap.add_argument("--recall-target", type=float, default=None, help="not ported")
    args = ap.parse_args(argv)
    if args.mode != "alsh":
        raise not_ported(f"--mode {args.mode}", UNPORTED_MODES[args.mode])
    serve_alsh(args)


if __name__ == "__main__":
    main()
