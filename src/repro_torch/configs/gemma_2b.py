"""gemma-2b [dense]: 18L, 8H MQA kv=1, GeGLU, head_dim 256, vocab 256000.

[arXiv:2403.08295; hf:google/gemma-2b] — embeddings scaled by sqrt(d_model),
tied unembedding, full global attention on every layer.

long_500k skipped: pure full attention (per spec, sub-quadratic archs only).
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="gemma-2b",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    scan_unit=("attn",),
    activation="geglu",
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="float32",
)

BUNDLE = ArchBundle(
    arch_id="gemma-2b",
    model=MODEL,
    train=TrainConfig(),
    shape_skips={"long_500k": "pure full-attention arch: 500k cell not run (per spec)"},
)
