"""Mutable index lifecycle in the PyTorch port: insert / delete / compact
without a rebuild. The twin of ``examples/streaming_updates.py``, on the
CUDA card by default.

    PYTHONPATH=src python examples/torch_streaming_updates.py [--n 20000]
    PYTHONPATH=src python examples/torch_streaming_updates.py --device cpu --n 4096

A sealed main segment plus a fixed-capacity delta segment for inserts
(hashed with the same tables, so one set of query keys is valid
everywhere) and a tombstone bitmap for deletes. Results stay EXACTLY what a
fresh build over the surviving rows returns (same seed ⇒ same tables ⇒
same hashes), and ``compact`` equals that fresh build leaf for leaf.
"""

import argparse
import time

import torch

from repro_torch.api import BoundedSpace, Index, IndexConfig, QuerySpec, UpdateSpec
from repro_torch.api.index import resolve_device
from repro_torch.distance import recall_at_k


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n, d, M, k = args.n, 16, 32, 10
    gen = torch.Generator().manual_seed(0)
    data = torch.rand((n, d), generator=gen).to(device)

    cfg = IndexConfig(d=d, M=M, K=10, L=32, family="theta",
                      max_candidates=512, space=BoundedSpace(0.0, 1.0, float(M)))
    update = UpdateSpec(delta_capacity=4096, compact_threshold=0.75)

    t0 = time.time()
    index = Index.build(1, data, cfg, update=update, device=device)
    _sync(device)
    t_build = time.time() - t0
    print(f"== built mutable index: n={n} sealed rows + "
          f"{update.delta_capacity} delta slots in {t_build:.2f}s on {device}")

    # --- inserts land in the delta segment (no sort, no rebuild) ------------
    m = 2048
    index, ids = index.insert(torch.rand((m, d), generator=gen).to(device))
    rows2 = torch.rand((m, d), generator=gen).to(device)
    _sync(device)
    t0 = time.time()
    index, ids2 = index.insert(rows2)
    _sync(device)
    print(f"== inserted 2x{m} rows (ids {int(ids[0])}..{int(ids2[-1])}); "
          f"insert: {m/(time.time()-t0):,.0f} rows/s (vs full rebuild {t_build:.2f}s)")

    # --- deletes tombstone (ids never come back) ----------------------------
    dead = torch.cat([torch.arange(100, dtype=torch.int32, device=device), ids[:100]])
    index = index.delete(dead)
    print(f"== deleted {dead.shape[0]} rows (100 sealed + 100 delta); "
          f"live rows: {index.n_live}, delta fill {index.delta_fill}/{update.delta_capacity}")

    # --- queries see one coherent view of both segments ---------------------
    b = 64
    q = torch.rand((b, d), generator=gen).to(device)
    w = (torch.randn((b, d), generator=gen).abs() + 0.2).to(device)
    res = index.query(q, w, QuerySpec(k=k))
    exact = index.query(q, w, QuerySpec(k=k, mode="exact"))
    assert not torch.isin(res.ids, dead).any()
    recall = recall_at_k(res.ids, exact.ids, k)
    print(f"== query over both segments: recall@{k}={recall:.2f}, "
          f"candidates/query ~{float(res.n_candidates.float().mean()):.0f} "
          f"of {index.n_live} live rows")

    # --- compact: merge delta + survivors into a fresh sealed segment -------
    t0 = time.time()
    index = index.compact()
    _sync(device)
    print(f"== compacted to n={index.n} sealed rows in {time.time()-t0:.2f}s "
          f"(the only operation that sorts; hashes were NOT recomputed)")

    # --- parity: bit-identical to a fresh build over the survivors ----------
    # (at a scale where the window C never truncates a bucket: under
    # truncation, the mutated and fresh indexes keep different — equally
    # valid — C-subsets of an oversized bucket)
    ns, caps = min(1500, n - 300), 512
    cfg_s = IndexConfig(d=d, M=M, K=10, L=16, family="theta",
                        max_candidates=ns + caps,
                        space=BoundedSpace(0.0, 1.0, float(M)))
    small = Index.build(6, data[:ns], cfg_s, update=UpdateSpec(delta_capacity=caps),
                        device=device)
    small, sids = small.insert(data[n - 300:n - 100])
    small = small.delete(torch.cat([torch.arange(40, dtype=torch.int32, device=device),
                                    sids[:40]]))
    live = torch.as_tensor(small.live_ids(), device=device)
    rows = torch.cat([data[:ns], data[n - 300:n - 100]])
    fresh = Index.build(6, rows[live], cfg_s, device=device)
    got = small.query(q, w, QuerySpec(k=k))
    want = fresh.query(q, w, QuerySpec(k=k))
    mapped = torch.where(want.ids >= 0, live[want.ids.clamp(min=0).long()], -1)
    assert torch.equal(got.ids.long(), mapped), "lifecycle parity broken"
    assert torch.equal(got.dists, want.dists)
    compacted = small.compact()
    for f in ("sorted_keys", "perm", "data", "levels"):
        assert torch.equal(getattr(compacted.state, f), getattr(fresh.state, f)), f
    print("== parity: mutated index == fresh build over survivors, and "
          "compact() == fresh build (bit-identical)")
    return recall


if __name__ == "__main__":
    main()
