"""llama4-maverick-400b-a17b [moe]: 48L, MoE 128 experts top-1, interleaved.

[hf:meta-llama/Llama-4-Maverick-17B-128E] — 40H GQA kv=8, head_dim 128, iRoPE
(3 chunked : 1 global-NoPE), MoE on every OTHER layer (128 routed top-1 +
shared expert, d_ff 8192); interleaved dense layers use d_ff 16384.
vocab 202048. ~400B total / ~17B active.

Memory posture: bf16 params AND bf16 optimizer moments (TrainConfig) so the
ZeRO-3-sharded train state fits the single-pod 256 x 16 GB mesh
(400e9 * (2+2+2+2) B / 256 ≈ 12.5 GB/chip).
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, MoEConfig, TrainConfig

MODEL = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    scan_unit=("chunked", "chunked_moe", "chunked", "global_nope_moe"),
    n_units=12,
    chunk_size=8192,
    rope_theta=500_000.0,
    activation="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=128, top_k=1, d_ff_expert=8192, n_shared=1, every=2, d_ff_dense=16384
    ),
    param_dtype="bfloat16",
)

BUNDLE = ArchBundle(
    arch_id="llama4-maverick-400b-a17b",
    model=MODEL,
    train=TrainConfig(optimizer_dtype="bfloat16"),
)
