"""glm4-9b [dense]: 40L, 32H GQA kv=2, SwiGLU, vocab 151552.

[hf:THUDM/glm-4-9b] — head_dim 128, RoPE, untied lm_head.
long_500k skipped: pure full-attention arch.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="glm4-9b",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151_552,
    scan_unit=("attn",),
    rope_theta=10_000.0,
    activation="swiglu",
    tie_embeddings=False,
    param_dtype="float32",
)

BUNDLE = ArchBundle(
    arch_id="glm4-9b",
    model=MODEL,
    train=TrainConfig(),
    shape_skips={"long_500k": "pure full-attention arch: 500k cell not run (per spec)"},
)
