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
ten architectures — dense, MoE, Mamba2, the zamba2 shared block, the audio
and vision frontends (``configs/``, ``models/``, ``runtime/serve_step.py``,
``runtime/retrieval.py``: prefill, greedy decode and the ALSH kNN-LM
attachment, whose lookups run the kernels below; ``serve --mode lm``); and
their training (``models.forward_train``, ``optim/``, ``data/``,
``runtime/train_step.py``, ``runtime/fault.py``: checkpointed restarts
with ``ckpt.AsyncCheckpointer``, ``runtime/pipeline.py``;
``launch/train.py``); and the mesh and dry-run tooling (``models/sharding.py``:
the PartitionSpec trees; the shard_map MoE impls in ``models/moe.py``;
``launch/specs.py``, ``launch/mesh.py``, ``launch/compile.py``,
``launch/dryrun.py``: every (arch × shape × mesh) cell run on meta tensors).
Its eight kernels are hand-written in CUDA for Hopper (``kernels/csrc``):
every Pallas kernel of the reference has a counterpart. Entry points run on the CUDA card unless
the caller asks for ``device="cpu"``; on CPU tensors the kernels' plain
PyTorch versions run.

``obs.py`` is the port's own, with no counterpart in the reference: the
query path's stage spans (``repro_torch.query``, ``.validate``, ``.keys``,
``.probe``, ``.dedupe``, ``.gather``, ``.scan``). An operator turns them on
by running any ``torch.profiler`` session around their calls; the spans are
then host events of that trace, and ``obs.stage_ms()`` gives each stage's
device-stream milliseconds. With no profiler recording they cost one check
each and record nothing.
"""
