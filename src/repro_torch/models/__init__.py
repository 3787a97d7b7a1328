"""The dense LM architectures in PyTorch — counterpart of ``repro.models``
for prefill and decode (``forward_train`` waits for ROADMAP.md Queue A item
14b; ``param_specs`` and ``cache_specs``, PartitionSpec trees, for 14d) —
and the handover of the reference's parameters and caches."""

from repro_torch.models.convert import caches_from_jax, params_from_jax
from repro_torch.models.model import (
    forward_decode,
    forward_prefill,
    init_caches,
    init_params,
)

__all__ = [
    "caches_from_jax",
    "forward_decode",
    "forward_prefill",
    "init_caches",
    "init_params",
    "params_from_jax",
]
