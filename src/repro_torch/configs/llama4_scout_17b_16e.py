"""llama4-scout-17b-16e [moe]: 48L, MoE 16 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E] — 40H GQA kv=8, head_dim 128, iRoPE
attention pattern (3 chunked-local : 1 global-NoPE), every layer MoE
(16 routed top-1, d_ff 8192, + 1 always-on shared expert), vocab 202048.

~109B total / ~17B active. long_500k runs: chunked layers are linear-in-S
(iRoPE is llama4's long-context mechanism); global-NoPE KV is decode-linear.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, MoEConfig, TrainConfig

MODEL = ModelConfig(
    name="llama4-scout-17b-16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    scan_unit=("chunked_moe", "chunked_moe", "chunked_moe", "global_nope_moe"),
    n_units=12,
    chunk_size=8192,
    rope_theta=500_000.0,
    activation="swiglu",
    tie_embeddings=False,
    moe=MoEConfig(
        n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1, every=1, d_ff_dense=16384
    ),
    param_dtype="bfloat16",
)

BUNDLE = ArchBundle(arch_id="llama4-scout-17b-16e", model=MODEL, train=TrainConfig())
