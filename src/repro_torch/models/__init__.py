"""The LM architectures in PyTorch — counterpart of ``repro.models`` for
training, prefill and decode of all ten configurations: dense, MoE
(``moe``, with its mesh impls), Mamba2 and the shared block (``ssm``), the
audio and vision frontends and encoder-only; their PartitionSpec trees
(``param_specs``, ``cache_specs``; ``sharding``) — and the handover of the
reference's parameters, caches and training state."""

from repro_torch.models.convert import caches_from_jax, params_from_jax, train_state_from_jax
from repro_torch.models.model import (
    cache_specs,
    forward_decode,
    forward_prefill,
    forward_train,
    init_caches,
    init_params,
    param_specs,
)

__all__ = [
    "cache_specs",
    "caches_from_jax",
    "forward_decode",
    "forward_prefill",
    "forward_train",
    "init_caches",
    "init_params",
    "param_specs",
    "params_from_jax",
    "train_state_from_jax",
]
