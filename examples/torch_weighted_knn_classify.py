"""Feature-weighted kNN classification with the PyTorch port — the paper's
motivating application ([3, 19]: per-query feature weighting for kNN
classifiers). The twin of ``examples/weighted_knn_classify.py``, on the
CUDA card by default.

    PYTHONPATH=src python examples/torch_weighted_knn_classify.py [--n 30000]
    PYTHONPATH=src python examples/torch_weighted_knn_classify.py --device cpu --n 4000

Synthetic task: 8-class Gaussian blobs in 24-D where only the first 8
features are informative (the classes share their centre on the other 16,
which carry only noise). A weighted-Manhattan kNN
with weights = estimated feature importance (signal-to-noise per
dimension) classifies far better than unweighted kNN — and ALSH answers
the weighted queries sublinearly with matching accuracy.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.api import BoundedSpace, Index, IndexConfig, QuerySpec
from repro_torch.api.index import resolve_device
from repro_torch.distance import brute_force_nn


def make_blobs(gen, centers, n, informative):
    n_classes, d = centers.shape
    labels = torch.randint(0, n_classes, (n,), generator=gen)
    noise = torch.randn((n, d), generator=gen)
    scale = torch.where(torch.arange(d) < informative, 0.12, 0.35)  # noisy tail dims
    return torch.clamp(centers[labels] + noise * scale[None, :], 0.0, 1.0), labels


def knn_accuracy(ids, train_labels, true_labels):
    ids = ids.cpu().numpy()
    votes = train_labels.numpy()[np.maximum(ids, 0)]
    pred = np.array([np.bincount(v[i >= 0] if (i >= 0).any() else [0]).argmax()
                     for v, i in zip(votes, ids)])
    return float(np.mean(pred == true_labels.numpy()))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=30_000)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    n, d, M, k, n_classes, informative = args.n, 24, 32, 15, 8, 8
    gen = torch.Generator().manual_seed(7)
    # train and test share the class centres (the reference example draws
    # each set's centres from its own key, which leaves the test labels
    # unrelated to the training ones)
    centers = torch.rand((n_classes, d), generator=gen) * 0.6 + 0.2
    centers[:, informative:] = 0.5  # the noise dims carry no class signal
    X, y = make_blobs(gen, centers, n, informative)
    Q, yq = make_blobs(gen, centers, 256, informative)

    # per-dimension importance weights (signal-to-noise estimate)
    within_var = torch.stack([X[y == c].var(dim=0, unbiased=False)
                              for c in range(n_classes)]).mean(0)
    total_var = X.var(dim=0, unbiased=False)
    wvec = torch.clamp(total_var / (within_var + 1e-6) - 1.0, 0.05, 50.0)
    W = wvec.expand(Q.shape).contiguous()
    X, Q, W = X.to(device), Q.to(device), W.to(device)

    print(f"== {n} train / {len(Q)} test, {d}-D, {informative} informative dims, on {device}")

    _, ids_unw = brute_force_nn(X, Q, torch.ones_like(Q), k=k)
    acc_unw = knn_accuracy(ids_unw, y, yq)
    _, ids_w = brute_force_nn(X, Q, W, k=k)
    acc_w = knn_accuracy(ids_w, y, yq)
    print(f"== exact kNN accuracy: unweighted {acc_unw:.3f}  ->  weighted {acc_w:.3f}")

    cfg = IndexConfig(d=d, M=M, K=12, L=32, family="theta",
                      max_candidates=256, space=BoundedSpace(0.0, 1.0, float(M)))
    index = Index.build(2, X, cfg, device=device)
    t0 = time.time()
    res = index.query(Q, W, QuerySpec(k=k))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    acc_alsh = knn_accuracy(res.ids, y, yq)
    cand = float(res.n_candidates.float().mean())
    print(f"== ALSH weighted kNN: accuracy {acc_alsh:.3f} in {time.time()-t0:.2f}s, "
          f"examining {cand/n:.1%} of the database per query")
    print("== (weights ride with the query -- no reindexing when importance changes)")
    return acc_unw, acc_w, acc_alsh


if __name__ == "__main__":
    main()
