"""Config schema: model architecture, input shapes, training/serving knobs.

Counterpart of ``repro.configs.base`` with unchanged fields and defaults.
Every assigned architecture is an ``ArchBundle`` in its own module under
``repro_torch/configs/`` and is selectable via ``--arch <id>`` in the
launchers; ``repro_torch.models`` runs the dense ones (the attention kinds
with a dense MLP) and raises for the rest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Layer kinds understood by the block engine (models/model.py):
#   "attn"        — full (global) attention, RoPE
#   "local"       — sliding-window attention (cfg.window), RoPE (local theta)
#   "global"      — full attention, RoPE (global theta)
#   "chunked"     — chunked local attention (cfg.chunk_size), RoPE  [llama4 iRoPE]
#   "global_nope" — full attention, NO positional encoding         [llama4 iRoPE]
#   "mamba2"      — Mamba2 SSD block
#   "shared_attn" — full attention with weights SHARED across occurrences [zamba2]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int = 1
    d_ff_expert: int = 8192
    n_shared: int = 1  # always-on shared experts (llama4 style)
    every: int = 1  # MoE on layers with (index % every == every - 1); others dense
    d_ff_dense: int = 16384  # d_ff of the interleaved dense layers
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class RetrievalConfig:
    """ALSH retrieval attachment for serving (the paper's technique as a feature)."""

    datastore_size: int = 65536  # records per data-axis shard
    d_key: int = 64  # reduced hidden-state key dim (random projection)
    M: int = 32
    K: int = 8
    L: int = 16
    family: str = "theta"
    max_candidates: int = 64
    topk: int = 8
    interp_lambda: float = 0.25  # logit interpolation weight
    # > 0 makes the datastore index mutable (streaming ingest of new
    # (hidden-state, token) records during serving; see runtime.retrieval)
    delta_capacity: int = 0
    # quality-first retrieval: when set, build_datastore resolves a
    # QualitySpec(k=topk, recall_target=...) through the planner EAGERLY
    # (the memoized plan then drives every decode-step lookup; the explicit
    # K/L/max_candidates above are the legacy path and still the default)
    recall_target: float | None = None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # layer pattern: n_layers == n_units * len(scan_unit) + len(tail)
    scan_unit: tuple = ("attn",)
    n_units: Optional[int] = None
    tail: tuple = ()
    # attention details
    causal: bool = True
    qk_norm: bool = False
    window: int = 512
    chunk_size: int = 8192
    rope_theta: float = 10_000.0
    rope_local_theta: Optional[float] = None
    pos: str = "rope"  # rope | mrope
    mrope_sections: tuple = (16, 24, 24)
    logit_softcap: Optional[float] = None
    activation: str = "swiglu"  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d_model)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # modality frontend stubs ([audio]/[vlm] archs)
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 512
    n_vision_tokens: int = 256
    encoder_only: bool = False
    # numerics / compilation
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    # ---- perf hillclimb levers (defaults = paper-faithful baseline) --------
    embed_table_spec: str = "vocab_model"  # "vocab_model" | "dm_data"
    logits_dtype: str = "float32"  # "float32" | "bfloat16"
    loss_chunk: int = 0  # >0: CE computed in seq chunks (never full (B,S,V))
    attn_blk_q: int = 512
    attn_blk_kv: int = 1024
    cache_spec_mode: str = "seq_model"  # "seq_model" | "heads_model"
    dp_over_model: bool = False  # True: model axis = extra DP (no activation TP)
    remat_policy: str = "nothing"  # "nothing" | "dots" (dots_with_no_batch_dims)
    moe_impl: str = "gspmd"  # "gspmd" | "ep_shardmap" (explicit EP, see moe.py)
    serve_param_layout: str = "fsdp"  # "fsdp" | "replicated" (decode/prefill only)

    @property
    def unit_len(self) -> int:
        return len(self.scan_unit)

    @property
    def resolved_units(self) -> int:
        if self.n_units is not None:
            return self.n_units
        assert (self.n_layers - len(self.tail)) % self.unit_len == 0, self.name
        return (self.n_layers - len(self.tail)) // self.unit_len

    def validate(self) -> None:
        assert self.resolved_units * self.unit_len + len(self.tail) == self.n_layers, (
            f"{self.name}: pattern {self.scan_unit}x{self.resolved_units}+{self.tail} "
            f"!= {self.n_layers} layers"
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: what to lower and at what size."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # memory / distribution knobs
    optimizer_dtype: str = "float32"  # moments dtype ("bfloat16" to halve HBM)
    microbatch: int = 1  # gradient-accumulation chunks per step
    grad_compression: Optional[str] = None  # None | "bf16" | "int8_ef"
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class ArchBundle:
    """Everything ``--arch <id>`` selects."""

    arch_id: str
    model: ModelConfig
    train: TrainConfig = TrainConfig()
    retrieval: Optional[RetrievalConfig] = None
    # which shape cells run for this arch (None = skip, with reason)
    shape_skips: dict = dataclasses.field(default_factory=dict)

    def runnable_shapes(self):
        return [s for s in SHAPES.values() if s.name not in self.shape_skips]
