"""Configurations: the ALSH service (``paper_alsh``) and the architecture
registry (``--arch <id>`` resolution and the reduced smoke configs).

Counterpart of ``repro.configs``: the same ten bundles under the same ids,
``list_archs`` and ``get_bundle`` as there, and ``reduced_model`` with the
reference's tiny dimensions.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    gemma3_1b,
    gemma_2b,
    glm4_9b,
    hubert_xlarge,
    llama4_maverick_400b_a17b,
    llama4_scout_17b_16e,
    mamba2_2p7b,
    qwen2_vl_2b,
    qwen3_8b,
    zamba2_7b,
)
from repro_torch.configs.base import (
    ArchBundle,
    ModelConfig,
    MoEConfig,
    RetrievalConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
)

_BUNDLES = {
    b.arch_id: b
    for b in [
        hubert_xlarge.BUNDLE,
        gemma3_1b.BUNDLE,
        gemma_2b.BUNDLE,
        qwen3_8b.BUNDLE,
        glm4_9b.BUNDLE,
        zamba2_7b.BUNDLE,
        llama4_scout_17b_16e.BUNDLE,
        llama4_maverick_400b_a17b.BUNDLE,
        qwen2_vl_2b.BUNDLE,
        mamba2_2p7b.BUNDLE,
    ]
}


def list_archs() -> list[str]:
    return sorted(_BUNDLES)


def get_bundle(arch_id: str) -> ArchBundle:
    if arch_id not in _BUNDLES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return _BUNDLES[arch_id]


def reduced_model(cfg: ModelConfig) -> ModelConfig:
    """Same family/pattern, tiny dimensions — for CPU smoke tests.

    Keeps the layer-kind structure (scan_unit/tail, MoE/SSM/frontends) so the
    smoke test exercises exactly the code paths of the full config.
    """
    unit = cfg.scan_unit
    tail = cfg.tail
    n_units = 2
    n_layers = n_units * len(unit) + len(tail)
    kv = 1 if cfg.n_kv_heads == 1 else 2
    updates = dict(
        n_layers=n_layers,
        n_units=n_units,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        window=32,
        chunk_size=64,
        frontend_dim=32,
        n_vision_tokens=8,
        mrope_sections=(2, 3, 3),  # scaled to head_dim 16 (half = 8)
        param_dtype="float32",
        compute_dtype="float32",
        remat=False,
    )
    if cfg.moe is not None:
        # capacity_factor = n_experts: no capacity drops at the smoke sizes
        updates["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, d_ff_expert=64, d_ff_dense=128, capacity_factor=4.0
        )
    if cfg.ssm is not None:
        updates["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
    if cfg.name == "mamba2-2.7b":
        updates["n_heads"] = 1
        updates["n_kv_heads"] = 1
    return dataclasses.replace(cfg, **updates)


__all__ = [
    "ArchBundle",
    "ModelConfig",
    "MoEConfig",
    "RetrievalConfig",
    "SHAPES",
    "ShapeConfig",
    "SSMConfig",
    "TrainConfig",
    "get_bundle",
    "list_archs",
    "reduced_model",
]
