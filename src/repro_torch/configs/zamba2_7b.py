"""zamba2-7b [hybrid]: 81L Mamba2 backbone + SHARED full-attention blocks.

[arXiv:2411.15242] — Mamba2 layers (ssm_state 64) with one shared
attention+MLP block woven in every 6th position (weights shared across all
occurrences — zamba2's parameter-reuse trick; per-occurrence KV caches stay
distinct). 32H MHA kv=32, head_dim 112, d_ff 14336, vocab 32000.

Pattern: (5 mamba2 + 1 shared_attn) x 13 + 3 mamba2 tail = 81 layers.
long_500k runs: SSM state carries long context; shared-attn KV is the only
S-dependent cache.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, SSMConfig, TrainConfig

MODEL = ModelConfig(
    name="zamba2-7b",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32_000,
    scan_unit=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "shared_attn"),
    n_units=13,
    tail=("mamba2", "mamba2", "mamba2"),
    activation="swiglu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, d_conv=4, n_groups=1, chunk=256),
    param_dtype="float32",
)

BUNDLE = ArchBundle(arch_id="zamba2-7b", model=MODEL, train=TrainConfig())
