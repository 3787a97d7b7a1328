"""AdamW and gradient compression — counterpart of ``repro.optim``
(``opt_state_specs``, a PartitionSpec tree, waits for ROADMAP.md Queue A
item 14d and is not exported)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    decompress_accumulate,
    init_opt_state,
    lr_schedule,
)

__all__ = [
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "compress_grads",
    "decompress_accumulate",
    "init_opt_state",
    "lr_schedule",
]
