"""The dense LM architectures in PyTorch — counterpart of ``repro.models``
for training, prefill and decode (``param_specs`` and ``cache_specs``,
PartitionSpec trees, wait for ROADMAP.md Queue A item 14d) — and the
handover of the reference's parameters, caches and training state."""

from repro_torch.models.convert import caches_from_jax, params_from_jax, train_state_from_jax
from repro_torch.models.model import (
    forward_decode,
    forward_prefill,
    forward_train,
    init_caches,
    init_params,
)

__all__ = [
    "caches_from_jax",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_caches",
    "init_params",
    "params_from_jax",
    "train_state_from_jax",
]
