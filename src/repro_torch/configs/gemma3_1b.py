"""gemma3-1b [dense]: 26L, 4H GQA kv=1, 5:1 local:global, 128k-class context.

[hf:google/gemma-3-1b-pt] — GeGLU, head_dim 256, qk-norm, sliding window 512
on local layers (rope theta 10k), global layers rope theta 1M, embeddings
scaled by sqrt(d_model), tied unembedding, 262144 vocab.

Pattern: (5 local + 1 global) x 4 units + 2 local tail = 26 layers.
long_500k runs: local layers are linear-in-S; the 4 global layers' KV at 500k
is ~4 GB bf16 (kv=1, head_dim 256) — manageable.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="gemma3-1b",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262_144,
    scan_unit=("local", "local", "local", "local", "local", "global"),
    n_units=4,
    tail=("local", "local"),
    window=512,
    qk_norm=True,
    rope_theta=1_000_000.0,
    rope_local_theta=10_000.0,
    activation="geglu",
    embed_scale=True,
    tie_embeddings=True,
    param_dtype="float32",
)

BUNDLE = ArchBundle(arch_id="gemma3-1b", model=MODEL, train=TrainConfig())
