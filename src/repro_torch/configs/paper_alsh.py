"""The paper's own workload: the ALSH vector-search service configuration.

Counterpart of ``repro.configs.paper_alsh`` with unchanged values: n=262,144
rows of d=128 per device, theta family, K=12 hashes x L=32 tables, window
C=128, query batches of 1024, top-10.
"""

import dataclasses

from repro_torch.core.index import IndexConfig
from repro_torch.core.transforms import BoundedSpace


@dataclasses.dataclass(frozen=True)
class ALSHServiceConfig:
    n_per_shard: int = 262_144  # database rows per device
    d: int = 128
    M: int = 32
    K: int = 12
    L: int = 32
    family: str = "theta"
    W: float = 8.0
    max_candidates: int = 128
    query_batch: int = 1024  # global query batch per serve step
    topk: int = 10

    @property
    def index_config(self) -> IndexConfig:
        return IndexConfig(
            d=self.d,
            M=self.M,
            K=self.K,
            L=self.L,
            family=self.family,
            W=self.W,
            max_candidates=self.max_candidates,
            space=BoundedSpace(0.0, 1.0, float(self.M)),
        )


SERVICE = ALSHServiceConfig()
