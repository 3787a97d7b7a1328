"""Fault-tolerant serving tier: broker, SLO degradation, shard chaos —
counterpart of ``repro.serving``.

Quickstart::

    from repro_torch.serving import (
        Broker, BrokerConfig, SLOConfig, ShardSet, ChaosPlan,
        poisson_trace, requests_from_trace,
    )

    index = Index.build(seed, data, QualitySpec(k=10, recall_target=0.9))
    shards = ShardSet.build(index, n_shards=4, root="/tmp/shards")
    shards.chaos = ChaosPlan(kill_shard=1, kill_at_s=0.5)
    broker = Broker(index, quality, SLOConfig(p99_ms=50.0), shardset=shards)
    reqs = requests_from_trace(poisson_trace(200.0, 1000), Q, W)
    responses, stats = broker.run(reqs)

See the module docstrings (``broker``, ``slo``, ``chaos``, ``arrivals``).
"""

from repro_torch.serving.arrivals import bursty_trace, make_trace, poisson_trace
from repro_torch.serving.broker import (
    Broker,
    BrokerConfig,
    BrokerStats,
    Request,
    Response,
    requests_from_trace,
)
from repro_torch.serving.chaos import ChaosPlan, ShardSet, ShardSetResult
from repro_torch.serving.slo import DegradationController, LatencyTracker, SLOConfig

__all__ = [
    "Broker",
    "BrokerConfig",
    "BrokerStats",
    "ChaosPlan",
    "DegradationController",
    "LatencyTracker",
    "Request",
    "Response",
    "SLOConfig",
    "ShardSet",
    "ShardSetResult",
    "bursty_trace",
    "make_trace",
    "poisson_trace",
    "requests_from_trace",
]
