"""PyTorch + CUDA port of the weighted-Manhattan ALSH system (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``, ``engine/``, ``api/``, ``ckpt/``, ``distance/``,
``configs/``, ``launch/``) so each module here has one counterpart there. It
imports ``torch`` and numpy only — never ``jax``, ``repro``, ``msgpack`` or
``ml_dtypes`` (``zstandard`` is used where it is installed).

Ported so far: the sealed index — build, single-probe and multiprobe query
and the exact scan — with f32, bf16 or int8 row storage and the quantized
proxy screen (``quant/``); the mutable index (insert, delete, the
two-segment query, compact); the streamed early-exit query
(``engine/stream.py``, with the paper's theory in ``core/theory.py``) and
``Index.explain`` with its ``QueryReport``; the materializing scan and
re-rank (``ops.wl1_scan``/``ops.wl1_rerank``); ``Index.save``/``Index.load``
in the reference's directory format (``api/persist.py``, ``ckpt/``); the
paper's unary embedding, the naive projection and the wl2 baseline; and
quality-first planning (``QualitySpec`` → ``Planner`` → ``PlannedSpec``,
``api/planner.py``) with the offline tuner (``tuner/``, ``launch/tune.py``);
and the serving tier (``serving/``: the broker, SLO degradation, shard
chaos; ``serve --mode broker``) with its rebuild guard
(``analysis/retrace_guard.py``); and the sharded index (``Index.shard``,
``ShardedIndex``, ``core/distributed.py``: one process drives every shard
of a ``make_mesh`` mesh, whose devices may repeat); and LM serving for the
dense architectures (``configs/``, ``models/``, ``runtime/serve_step.py``,
``runtime/retrieval.py``: prefill, greedy decode and the ALSH kNN-LM
attachment, whose lookups run the kernels below; ``serve --mode lm``); and
their training (``models.forward_train``, ``optim/``, ``data/``,
``runtime/train_step.py``, ``runtime/fault.py``: checkpointed restarts
with ``ckpt.AsyncCheckpointer``, ``runtime/pipeline.py``;
``launch/train.py``).
Its eight kernels are hand-written in CUDA for Hopper (``kernels/csrc``):
every Pallas kernel of the reference has a counterpart. Entry points run on the CUDA card unless
the caller asks for ``device="cpu"``; on CPU tensors the kernels' plain
PyTorch versions run.
Parts that are not ported yet (the MoE, SSM, shared-block, frontend and
encoder-only architectures, the PartitionSpec trees) raise
:class:`NotImplementedError` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

__all__ = ["not_ported"]


def not_ported(feature: str, roadmap_item: str) -> NotImplementedError:
    """The error every unported mode raises: names the feature and the
    ``ROADMAP.md`` item that will port it (never a silent fallback)."""
    return NotImplementedError(
        f"{feature} is not ported to repro_torch yet (ROADMAP.md {roadmap_item}); "
        f"use the JAX package `repro` for it"
    )
