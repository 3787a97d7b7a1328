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

:class:`AsyncCheckpointer` overlaps a save's serialization and IO with the
next training steps, one save in flight at a time. It copies the leaves to
host memory of their own inside ``save()``, before its thread starts: on
the CPU ``tensor.cpu()`` is the tensor itself, which a later update could
otherwise change under the writer.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import zlib
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.ckpt import _msgpack

__all__ = [
    "AsyncCheckpointer",
    "BFLOAT16",
    "Bits",
    "CorruptCheckpointError",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
    "host_copy",
    "leaf_tensor",
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


def host_copy(leaf):
    """A checkpoint leaf in host memory of its own: a tensor (on any
    device) or numpy array copied to a numpy array, a bfloat16 tensor to
    the :class:`Bits` of its pattern, a :class:`Bits` copied."""
    if isinstance(leaf, Bits):
        return Bits(leaf.dtype, np.array(leaf.bits))
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True).contiguous()
        if t.dtype == torch.bfloat16:
            return Bits(BFLOAT16, t.view(torch.int16).numpy().view(np.uint16))
        return t.numpy()
    return np.array(leaf)


def leaf_tensor(leaf) -> torch.Tensor:
    """The inverse of :func:`host_copy`: a numpy leaf as a CPU tensor of its
    own memory (a copy), a :class:`Bits` or a numpy ``bfloat16`` array
    (``ml_dtypes``, as the reference's trees hold them, which torch cannot
    read) by its 16-bit pattern, bit for bit; a tensor is returned as it is."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, Bits):
        return torch.from_numpy(np.array(leaf.bits, order="C").view(np.int16)).view(
            torch.bfloat16)
    arr = np.array(leaf, order="C")  # a copy; keeps a 0-d leaf 0-d
    if arr.dtype.name == BFLOAT16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class AsyncCheckpointer:
    """Overlap checkpoint IO with training (one in-flight save).

    Use as a context manager: ``__exit__`` flushes the in-flight save even
    when an exception unwinds the training loop, so a restart's
    ``latest_step`` read can never race the writer thread. When the body
    is already unwinding, a save error is swallowed (the restart recovers
    from the previous commit, which is exactly the crash contract); on the
    clean path it propagates.
    """

    def __init__(self, directory: str):
        self.directory = directory
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        try:
            self.wait()
        except BaseException:
            if exc_type is None:
                raise
            # already unwinding (an injected failure): the primary error
            # wins; the restart resumes from the previous commit
        return False

    def save(self, step: int, leaves: Mapping) -> None:
        """Start writing ``leaves`` (leaf path -> tensor, numpy array or
        :class:`Bits`) as ``step``, after the previous save has finished;
        the host copies are taken here, before the thread starts."""
        self.wait()
        host = {k: host_copy(v) for k, v in leaves.items()}

        def run():
            try:
                save_checkpoint(self.directory, step, host)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
