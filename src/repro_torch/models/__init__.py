"""The LM architectures in PyTorch — counterpart of ``repro.models`` for
training, prefill and decode of all ten configurations: dense, MoE
(``moe``), Mamba2 and the shared block (``ssm``), the audio and vision
frontends and encoder-only (``param_specs`` and ``cache_specs``,
PartitionSpec trees, and the shard_map MoE impls wait for ROADMAP.md Queue
A item 14d) — and the handover of the reference's parameters, caches and
training state."""

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
