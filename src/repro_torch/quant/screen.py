"""The quantized-proxy screen — counterpart of ``repro.quant.screen``.

For the symmetric int8 codec the weighted-l1 distance between dequantized
rows factors through the stored levels,

    d_w(x̂, q̂) = Σ_j (w_j·s_j) · |enc_x[j] − enc_q[j]|,

so the screen needs no decode: quantize the query once per batch, fold the
scales into the weights, and run the same fused gather/top-k kernel over the
raw int8 rows. For bf16 the proxy is the weighted-l1 between the
bf16-rounded query and the bf16 rows. The proxy only SELECTS the top
``keep = ceil(k·α)`` survivors; the exact rerank over decoded rows has the
final word.
"""

from __future__ import annotations

import math

import torch

from repro_torch.quant.codecs import _INT8_MAX


def proxy_query(
    queries: torch.Tensor, weights: torch.Tensor, storage_dtype: torch.dtype,
    scales: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(queries, weights) -> (q', w') such that the gather kernel over the
    RAW encoded rows computes the screening proxy distance.

    int8 (``scales`` present): q' is the quantized query in integer levels
    (f32-valued), w' = w·s. bf16: q' is the bf16-rounded query widened back
    to f32, w' unchanged. f32: identity."""
    q = queries.to(torch.float32)
    w = weights.to(torch.float32)
    if scales is not None:
        enc_q = torch.clamp(torch.round(q / scales), -_INT8_MAX, _INT8_MAX)
        return enc_q, w * scales
    if storage_dtype == torch.bfloat16:
        return q.to(torch.bfloat16).to(torch.float32), w
    return q, w


def screen_keep(k: int, screen_alpha: float, n_slots: int) -> int:
    """Survivor count of a screen pass: ``ceil(k·α)`` clamped to
    ``[k, n_slots]``; 0 (screen off) when α is 0 or the survivors would
    cover every candidate slot anyway."""
    if not screen_alpha or screen_alpha <= 0.0:
        return 0
    keep = max(int(k), int(math.ceil(k * screen_alpha)))
    if keep >= n_slots:
        return 0
    return keep
