"""hubert-xlarge [audio]: 48L encoder-only, GQA kv=16 (full MHA), vocab 504.

[arXiv:2106.07447] — same backbone as wav2vec2-XL. The conv waveform frontend
is a STUB: ``input_specs`` provides precomputed 512-dim frame embeddings (the
frontend_proj maps them into the 1280-dim residual stream). Training objective
is HuBERT's masked-prediction CE over the 504-unit codebook.

Deviations noted in DESIGN.md: conv positional embedding → RoPE
(bidirectional); encoder-only ⇒ decode_32k / long_500k cells skipped.
"""

from repro_torch.configs.base import ArchBundle, ModelConfig, TrainConfig

MODEL = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    scan_unit=("attn",),
    causal=False,
    encoder_only=True,
    activation="gelu",
    frontend="audio",
    frontend_dim=512,
    tie_embeddings=False,
    param_dtype="float32",
)

BUNDLE = ArchBundle(
    arch_id="hubert-xlarge",
    model=MODEL,
    train=TrainConfig(),
    shape_skips={
        "decode_32k": "encoder-only architecture: no autoregressive decode step",
        "long_500k": "encoder-only architecture: no decode; 500k bidirectional encode not a defined cell",
    },
)
