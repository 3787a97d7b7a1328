"""qwen2-vl-2b [vlm]: 28L, 12H GQA kv=2, M-RoPE, dynamic-resolution vision.

[arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B] — SwiGLU d_ff 8960, vocab 151936,
tied embeddings. The vision tower is a STUB: ``input_specs`` provides 256
precomputed patch embeddings (frontend_dim 1280, mapped by vision_proj — the
"merger" stand-in) plus the 3D (t, h, w) M-RoPE position grids for the full
sequence. Backbone M-RoPE sections (16, 24, 24) over the 64 half-dims.

long_500k skipped: pure full-attention arch.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    scan_unit=("attn",),
    pos="mrope",
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=True,
    frontend="vision",
    frontend_dim=1280,
    n_vision_tokens=256,
    param_dtype="float32",
)

BUNDLE = ArchBundle(
    arch_id="qwen2-vl-2b",
    model=MODEL,
    train=TrainConfig(),
    shape_skips={"long_500k": "pure full-attention arch: 500k cell not run (per spec)"},
)
