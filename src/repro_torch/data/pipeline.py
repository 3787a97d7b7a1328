"""Deterministic, resumable, shard-aware synthetic data pipeline.

Counterpart of ``repro.data.pipeline``, draw for draw: the batch for step s
is a pure function of (seed, step, shard) and comes back as numpy arrays,
the same bytes the reference's stream gives (``tests/test_torch_train.py``
holds them equal). Resuming from a checkpoint at step s therefore
reproduces the exact remaining stream — no iterator state to persist beyond
the step counter, which lives in the train state — and any host can compute
any shard's batch for any step, so backup workers and re-sharding need no
data re-coordination.

The synthetic LM stream is structured (Zipf-ish marginals + a Markov-like
local dependency) so a small model visibly learns within a few hundred
steps rather than flat-lining at log V. The audio and vision batches are
data only: their models wait for ROADMAP.md Queue A item 14c.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_shards: int = 1  # data-parallel shards
    shard_id: int = 0


class SyntheticStream:
    """Synthetic token/frame stream; ``batch(step)`` is pure in (cfg, step)."""

    def __init__(self, dcfg: DataConfig, mcfg: ModelConfig):
        if dcfg.global_batch % dcfg.n_shards:
            raise ValueError(f"global_batch {dcfg.global_batch} does not split into "
                             f"{dcfg.n_shards} shards")
        self.dcfg = dcfg
        self.mcfg = mcfg
        self.local_batch = dcfg.global_batch // dcfg.n_shards

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.dcfg.seed * 1_000_003 + step) * 4099 + self.dcfg.shard_id
        )

    def _lm_tokens(self, rng, batch: int, seq: int, vocab: int) -> np.ndarray:
        # Zipf-ish unigram + short-range repetition structure
        base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64) % vocab
        rep = rng.random((batch, seq)) < 0.35
        shifted = np.roll(base, 3, axis=1)
        out = np.where(rep, shifted, base)
        return out.astype(np.int32)

    def batch(self, step: int) -> dict:
        d, m = self.dcfg, self.mcfg
        rng = self._rng(step)
        B, S = self.local_batch, d.seq_len
        if m.frontend == "audio":
            targets = self._lm_tokens(rng, B, S, m.vocab_size)
            # frames correlate with targets so masked prediction is learnable
            proj = rng.standard_normal((m.vocab_size, m.frontend_dim)).astype(np.float32)
            frames = proj[targets] + 0.1 * rng.standard_normal(
                (B, S, m.frontend_dim)
            ).astype(np.float32)
            mask = rng.random((B, S)) < 0.3
            return {"frames": frames, "targets": targets, "mask": mask}
        if m.frontend == "vision":
            nv = min(m.n_vision_tokens, S // 2)  # clamp for tiny test seqs
            tokens = self._lm_tokens(rng, B, S - nv, m.vocab_size)
            patches = rng.standard_normal((B, nv, m.frontend_dim)).astype(np.float32)
            t = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
            positions = np.stack([t, t, t])  # text-equivalent 3D grid stub
            return {"tokens": tokens, "patches": patches, "positions": positions}
        return {"tokens": self._lm_tokens(rng, B, S, m.vocab_size)}
