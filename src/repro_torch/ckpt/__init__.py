"""Committed-step checkpoints in the reference's on-disk format (msgpack +
zstd or zlib, per-leaf CRC, atomic COMMIT), written in place or by the
:class:`AsyncCheckpointer` while training goes on."""

from repro_torch.ckpt.checkpoint import (
    AsyncCheckpointer,
    BFLOAT16,
    Bits,
    CorruptCheckpointError,
    host_copy,
    latest_step,
    leaf_tensor,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "AsyncCheckpointer",
    "BFLOAT16",
    "Bits",
    "CorruptCheckpointError",
    "host_copy",
    "latest_step",
    "leaf_tensor",
    "restore_checkpoint",
    "save_checkpoint",
]
