"""mamba2-2.7b [ssm]: 64L attention-free SSD (state-space duality).

[arXiv:2405.21060] — d_model 2560, ssm_state 128, head_dim 64, expand 2
(d_inner 5120, 80 SSM heads), vocab 50280, tied embeddings. No attention,
no positional encoding (the SSM recurrence carries order).

All four shape cells run: decode is a constant-size state update; long_500k
is the arch's home turf.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, SSMConfig, TrainConfig

MODEL = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=1,  # unused (attention-free) — kept for schema completeness
    n_kv_heads=1,
    head_dim=64,
    d_ff=0,  # no FFN in mamba2 blocks
    vocab_size=50_280,
    scan_unit=("mamba2",),
    activation="swiglu",
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, n_groups=1, chunk=256),
    param_dtype="float32",
)

BUNDLE = ArchBundle(arch_id="mamba2-2.7b", model=MODEL, train=TrainConfig())
