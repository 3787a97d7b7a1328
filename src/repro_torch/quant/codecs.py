"""Row codecs: how a table segment's rows are stored on the device.

Counterpart of ``repro.quant.codecs``. A codec maps an ``(n, d)`` f32 row
block to its ENCODED payload (plus an optional ``(d,)`` f32 scale vector)
and back:

  * ``encode`` runs once per sealed segment, at build time, AFTER hashing:
    lattice levels and bucket keys always come from the raw rows, so the
    probe stage is codec-invariant;
  * ``encode_rows`` encodes rows under EXISTING scales (saturating);
  * ``decode`` is the identity for ``f32`` (the same tensor), a widening
    cast for ``bf16`` (exact), and ``payload * scales`` for ``int8``;
  * the query tail never decodes the whole table: the kernels decode per
    gathered row, the plain version per gathered chunk. ``decode_table``
    is for the oracle path (the exact scan) only.

Symmetric int8: ``scale_j = max_i |x_ij| / 127`` per dimension (1.0 for an
all-zero dimension), ``enc = clip(round(x / scale), -127, 127)``;
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses

import torch

STORAGE_KINDS = ("f32", "bf16", "int8")

# int8 symmetric range: full [-127, 127] (-128 unused keeps |enc| symmetric)
_INT8_MAX = 127.0


@dataclasses.dataclass(frozen=True)
class RowCodec:
    """One storage format for table-segment rows: ``name`` is the
    ``IndexConfig.storage`` value, ``dtype`` the payload dtype,
    ``bytes_per_value`` the payload bytes per coordinate, ``scaled``
    whether a ``(d,)`` scale vector is stored."""

    name: str
    dtype: torch.dtype
    bytes_per_value: int
    scaled: bool

    def encode(self, data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(n, d) f32 rows -> (payload, scales-or-None). Build time only."""
        if self.name == "f32":
            return data, None
        if self.name == "bf16":
            return data.to(torch.bfloat16), None
        scales = self.fit_scales(data)
        return self.encode_rows(data, scales), scales

    def fit_scales(self, data: torch.Tensor) -> torch.Tensor:
        """(d,) f32 symmetric per-dimension scales of a row block; an
        all-zero dimension gets 1.0 (a zero scale would decode 0/0)."""
        amax = data.to(torch.float32).abs().amax(dim=0)
        return torch.where(amax > 0, amax / _INT8_MAX, torch.ones_like(amax))

    def encode_rows(self, rows: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
        """Encode rows under existing scales; out-of-range values saturate."""
        if self.name == "f32":
            return rows.to(torch.float32)
        if self.name == "bf16":
            return rows.to(torch.bfloat16)
        q = torch.round(rows.to(torch.float32) / scales)
        return torch.clamp(q, -_INT8_MAX, _INT8_MAX).to(torch.int8)

    def decode(self, payload: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
        """Encoded rows -> f32 rows (an f32 payload passes through untouched)."""
        if payload.dtype == torch.float32:
            return payload
        out = payload.to(torch.float32)
        if scales is not None:
            out = out * scales
        return out


_CODECS = {
    "f32": RowCodec(name="f32", dtype=torch.float32, bytes_per_value=4, scaled=False),
    "bf16": RowCodec(name="bf16", dtype=torch.bfloat16, bytes_per_value=2, scaled=False),
    "int8": RowCodec(name="int8", dtype=torch.int8, bytes_per_value=1, scaled=True),
}


def get_codec(name: str) -> RowCodec:
    codec = _CODECS.get(name)
    if codec is None:
        raise ValueError(f"unknown storage codec {name!r}; registered codecs: {STORAGE_KINDS}")
    return codec


def storage_dtype(name: str) -> torch.dtype:
    """Payload dtype of a named codec."""
    return get_codec(name).dtype


def bytes_per_value(name: str) -> int:
    return get_codec(name).bytes_per_value


def codec_for_dtype(dtype: torch.dtype) -> RowCodec:
    """The codec whose payload dtype matches a stored segment tensor."""
    for codec in _CODECS.values():
        if codec.dtype == dtype:
            return codec
    raise ValueError(
        f"no registered storage codec stores dtype {dtype} — the payload was "
        f"written by an incompatible build"
    )


def decode_table(payload: torch.Tensor, scales: torch.Tensor | None) -> torch.Tensor:
    """Whole-table decode for the ORACLE path only (the exact scan). The
    query tail never calls this: it decodes per gathered row."""
    return codec_for_dtype(payload.dtype).decode(payload, scales)
