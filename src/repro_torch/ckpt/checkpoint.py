"""Committed-step checkpoints — counterpart of ``repro.ckpt.checkpoint``,
in the same on-disk format.

Layout (one directory per step):

    <dir>/step_000000123/shard_<k>.msgpack.zst   — the leaves (.msgpack.zlib
                                                   when written by the zlib
                                                   fallback)
    <dir>/step_000000123/COMMIT                  — written LAST

A step is written to ``step_…tmp``, synced, renamed into place, and only
then gets its ``COMMIT`` file, so a crash mid-write is never restored from.
The payload is one msgpack map from leaf path (``"state/4"``) to
``{dtype, shape, data, crc}``, where ``crc`` is the ``zlib.crc32`` of the
raw bytes, checked on restore. It is compressed with zstd level 3 when
``zstandard`` imports, else with zlib level 3; the reader dispatches on the
frame magic.

The port has no pytree: ``save_checkpoint`` takes an ordered mapping from
the reference's leaf path strings to numpy arrays, and
``restore_checkpoint`` returns the leaves it is asked for by name. A
bfloat16 leaf, which numpy names only with ``ml_dtypes``, travels as
:class:`Bits`: its 16-bit pattern under the dtype string ``"bfloat16"``.
Neither ``msgpack`` nor ``ml_dtypes`` is imported (``_msgpack`` packs the
subset the payload uses), and ``zstandard`` is imported inside the two
entry points, so ``import repro_torch`` works without any of them.
"""

from __future__ import annotations

import os
import re
import shutil
import zlib
from typing import Mapping, NamedTuple, Optional

import numpy as np

from repro_torch.ckpt import _msgpack

__all__ = [
    "BFLOAT16",
    "Bits",
    "CorruptCheckpointError",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]


class CorruptCheckpointError(ValueError):
    """A committed checkpoint's bytes do not decode or verify: a truncated
    or bit-flipped payload (decompress or unpack failure, a per-leaf CRC
    mismatch, a leaf that does not match its recorded dtype or shape)."""


BFLOAT16 = "bfloat16"


class Bits(NamedTuple):
    """A leaf numpy cannot name without ``ml_dtypes``: the dtype string the
    payload records for it and its raw bit pattern (a uint16 array for
    ``"bfloat16"``)."""

    dtype: str
    bits: np.ndarray


_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
# the extension says what the writer produced; the reader accepts either
_SHARD_EXTS = (".msgpack.zst", ".msgpack.zlib")


def _zstd():
    """The ``zstandard`` module, or None where it is not installed."""
    try:
        import zstandard
    except ModuleNotFoundError:
        return None
    return zstandard


def _compress(raw: bytes, zstd) -> bytes:
    if zstd is not None:
        return zstd.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 3)


def _decompress(blob: bytes, zstd) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        if zstd is None:
            raise ModuleNotFoundError(
                "checkpoint was written with zstandard, which is not installed"
            )
        return zstd.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _record(leaf) -> dict:
    if isinstance(leaf, Bits):
        dtype, arr = leaf.dtype, np.asarray(leaf.bits)
    else:
        arr = np.asarray(leaf)
        dtype = str(arr.dtype)
    data = arr.tobytes()  # C order whatever the layout; keeps a () leaf's shape
    return {"dtype": dtype, "shape": list(arr.shape), "data": data, "crc": zlib.crc32(data)}


def save_checkpoint(directory: str, step: int, leaves: Mapping, shard_id: int = 0) -> str:
    """Serialize ``leaves`` (leaf path -> numpy array or :class:`Bits`, in
    payload order) and commit one step atomically. Returns the step dir."""
    zstd = _zstd()
    step_dir = os.path.join(directory, f"step_{step:09d}")
    tmp_dir = step_dir + ".tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    raw = _msgpack.packb({k: _record(v) for k, v in leaves.items()})
    comp = _compress(raw, zstd)
    del raw
    ext = _SHARD_EXTS[0] if zstd is not None else _SHARD_EXTS[1]
    with open(os.path.join(tmp_dir, f"shard_{shard_id}{ext}"), "wb") as f:
        f.write(comp)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(step_dir):
        shutil.rmtree(step_dir)
    os.replace(tmp_dir, step_dir)
    with open(os.path.join(step_dir, "COMMIT"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    return step_dir


def latest_step(directory: str) -> Optional[int]:
    """Largest committed step in the directory (None if nothing committed)."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "COMMIT")):
            s = int(m.group(1))
            best = s if best is None or s > best else best
    return best


def restore_checkpoint(directory: str, step: int, names, shard_id: int = 0) -> dict:
    """The leaves named in ``names`` of one committed step: leaf path ->
    numpy array (writable, its own memory), or :class:`Bits` for a
    bfloat16 leaf."""
    zstd = _zstd()
    step_dir = os.path.join(directory, f"step_{step:09d}")
    for ext in _SHARD_EXTS:
        fname = os.path.join(step_dir, f"shard_{shard_id}{ext}")
        if os.path.exists(fname):
            break
    else:
        raise FileNotFoundError(f"no shard_{shard_id} file in {step_dir}")
    with open(fname, "rb") as f:
        blob = f.read()
    try:
        raw = _decompress(blob, zstd)
        del blob
        payload = _msgpack.unpackb(raw)
    except ModuleNotFoundError:
        raise  # a zstd file without zstandard installed: actionable as it is
    except Exception as e:
        raise CorruptCheckpointError(
            f"checkpoint shard {fname} is corrupt (truncated or bit-flipped "
            f"payload): {type(e).__name__}: {e}"
        ) from e
    del raw
    if not isinstance(payload, dict):
        raise CorruptCheckpointError(
            f"checkpoint shard {fname} decoded to {type(payload).__name__}, "
            f"not a leaf mapping — corrupt payload"
        )
    out = {}
    for key in names:
        if key not in payload:
            raise KeyError(f"checkpoint missing leaf {key}")
        rec = payload[key]
        if "crc" in rec and zlib.crc32(rec["data"]) != rec["crc"]:
            raise CorruptCheckpointError(
                f"checkpoint shard {fname} leaf {key!r} fails its CRC — "
                f"bytes were corrupted after commit; restore from another step"
            )
        try:
            if rec["dtype"] == BFLOAT16:
                out[key] = Bits(BFLOAT16, np.frombuffer(rec["data"], np.uint16)
                                .reshape(rec["shape"]).copy())
            else:
                out[key] = np.frombuffer(rec["data"], dtype=np.dtype(rec["dtype"])).reshape(
                    rec["shape"]).copy()
        except (ValueError, TypeError) as e:
            raise CorruptCheckpointError(
                f"checkpoint shard {fname} leaf {key!r} does not match its "
                f"recorded dtype/shape ({e}) — corrupt payload"
            ) from e
    return out
