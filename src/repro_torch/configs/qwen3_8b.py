"""qwen3-8b [dense]: 36L, 32H GQA kv=8, qk-norm, SwiGLU, vocab 151936.

[hf:Qwen/Qwen3-8B] — head_dim 128, untied lm_head, rope theta 1M.
long_500k skipped: pure full-attention arch.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="qwen3-8b",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151_936,
    scan_unit=("attn",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    activation="swiglu",
    tie_embeddings=False,
    param_dtype="float32",
)

BUNDLE = ArchBundle(
    arch_id="qwen3-8b",
    model=MODEL,
    train=TrainConfig(),
    shape_skips={"long_500k": "pure full-attention arch: 500k cell not run (per spec)"},
)
