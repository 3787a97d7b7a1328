"""Quantized table tier: compressed row storage + proxy screening.

Counterpart of ``repro.quant``. Codecs ``f32`` (passthrough, the default),
``bf16`` (2x smaller, exact widening decode) and ``int8`` (4x smaller,
symmetric per-dimension scales). Hash keys come from the raw rows before
encoding, so candidate generation is identical across codecs; only the
rerank tail sees the compression.
"""

from repro_torch.quant.codecs import (
    STORAGE_KINDS,
    RowCodec,
    bytes_per_value,
    decode_table,
    get_codec,
    storage_dtype,
)
from repro_torch.quant.screen import proxy_query, screen_keep

__all__ = [
    "STORAGE_KINDS",
    "RowCodec",
    "bytes_per_value",
    "decode_table",
    "get_codec",
    "proxy_query",
    "screen_keep",
    "storage_dtype",
]
