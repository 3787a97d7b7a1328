"""End-to-end training in the PyTorch port: a small qwen3-family model on
the synthetic LM stream with the full stack (AdamW, microbatch
accumulation, async checkpointing, restart-safe data). The twin of
``examples/train_small.py``, on the CUDA card by default.

    PYTHONPATH=src python examples/torch_train_small.py             # ~20M smoke
    PYTHONPATH=src python examples/torch_train_small.py --full      # ~100M, 300 steps
    PYTHONPATH=src python examples/torch_train_small.py --device cpu --steps 2 \\
        --seq-len 32 --global-batch 2

The loss should fall well below the unigram entropy of the stream within
the first hundred steps (the stream has learnable structure; see
``repro_torch/data/pipeline.py``). The checkpoints go to
``repro_torch_train_small`` under the temporary directory unless
``--ckpt-dir`` names another; a run resumes from the newest commit there.
"""

import argparse
import dataclasses
import math
import os
import tempfile
import time

from repro_torch.api.index import resolve_device
from repro_torch.configs import ModelConfig, TrainConfig, get_bundle
from repro_torch.configs.base import ArchBundle
from repro_torch.data.pipeline import DataConfig
from repro_torch.models.model import init_tree
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime.fault import train_loop


def small_qwen(full: bool) -> ModelConfig:
    if full:  # ~100M-param backbone (plus embeddings)
        return dataclasses.replace(
            get_bundle("qwen3-8b").model,
            n_layers=12, n_units=12, d_model=768, n_heads=12, n_kv_heads=4,
            head_dim=64, d_ff=2048, vocab_size=8192, param_dtype="float32",
            compute_dtype="float32", remat=False,
        )
    return dataclasses.replace(
        get_bundle("qwen3-8b").model,
        n_layers=4, n_units=4, d_model=384, n_heads=6, n_kv_heads=2,
        head_dim=64, d_ff=1024, vocab_size=4096, param_dtype="float32",
        compute_dtype="float32", remat=False,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_small under the temporary directory")
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_small")
    mcfg = small_qwen(args.full)
    steps = args.steps or (300 if args.full else 60)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=20, total_steps=steps,
                       microbatch=1)
    bundle = ArchBundle(arch_id="train-small", model=mcfg, train=tcfg)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)

    n_params = sum(t.numel() for t in tree_leaves(init_tree(None, mcfg)))  # meta: no memory
    print(f"[train_small] {n_params/1e6:.1f}M params, {steps} steps, "
          f"seq {args.seq_len} x batch {args.global_batch} on {device}")

    t0 = time.time()
    losses = []

    def log(step, m):
        losses.append(m["loss"])
        if step % 10 == 0 or step == 1:
            print(f"  step {step:4d}  loss {m['loss']:.4f}  "
                  f"({(time.time()-t0)/step:.2f}s/step)")

    train_loop(bundle, dcfg, steps, ckpt_dir, ckpt_every=50,
               async_ckpt=True, on_metrics=log, device=device)
    if not losses or not all(math.isfinite(x) for x in losses):
        raise RuntimeError(f"train_small: losses {losses[:4]}… are not all finite")
    head, tail = losses[:10], losses[-10:]
    first, last = sum(head) / len(head), sum(tail) / len(tail)
    print(f"[train_small] loss {first:.3f} -> {last:.3f} "
          f"({'LEARNING' if last < first - 0.3 else 'check config'})")
    return losses


if __name__ == "__main__":
    main()
