"""Committed-step checkpoints in the reference's on-disk format (msgpack +
zstd or zlib, per-leaf CRC, atomic COMMIT)."""

from repro_torch.ckpt.checkpoint import (
    BFLOAT16,
    Bits,
    CorruptCheckpointError,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "BFLOAT16",
    "Bits",
    "CorruptCheckpointError",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
