"""Reference weighted distances and the brute-force oracle."""

from repro_torch.distance.wl1 import (
    brute_force_nn,
    pairwise_wl1,
    recall_at_k,
    wl1_distance,
    wl2_distance,
)

__all__ = ["brute_force_nn", "pairwise_wl1", "recall_at_k", "wl1_distance", "wl2_distance"]
