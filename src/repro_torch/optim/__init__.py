"""AdamW and gradient compression — counterpart of ``repro.optim``, with
the optimizer state's PartitionSpec tree (``opt_state_specs``)."""

from repro_torch.optim.adamw import (
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    compress_grads,
    decompress_accumulate,
    init_opt_state,
    lr_schedule,
    opt_state_specs,
)

__all__ = [
    "AdamWState",
    "adamw_update",
    "clip_by_global_norm",
    "compress_grads",
    "decompress_accumulate",
    "init_opt_state",
    "lr_schedule",
    "opt_state_specs",
]
