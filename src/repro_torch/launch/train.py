"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Counterpart of ``repro.launch.train``, with the same flags and lines, plus
``--device`` (default: the CUDA card; ``--device cpu`` runs on the CPU).
Runs real steps of the dense architectures (``--reduced`` for the tiny
smoke dimensions); the others raise ``NotImplementedError`` naming their
ROADMAP.md item.

Fault tolerance is on by default: resumes from the newest committed
checkpoint in ``--ckpt-dir`` and checkpoints every ``--ckpt-every`` steps
(async). The directory defaults to ``repro_torch_train_ckpt`` under the
temporary directory (``tempfile.gettempdir()``, which follows ``TMPDIR``),
so runs with their own ``TMPDIR`` never share one.

    python -m repro_torch.launch.train --arch gemma3-1b --reduced --steps 20
    python -m repro_torch.launch.train --arch gemma3-1b --reduced --device cpu --steps 4 \\
        --seq-len 32 --global-batch 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--reduced", action="store_true", help="tiny smoke config")
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train_ckpt under the temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--grad-compression", default=None, choices=[None, "bf16", "int8_ef"])
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.api.index import resolve_device
    from repro_torch.configs import get_bundle, reduced_model
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.fault import train_loop

    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")
    bundle = get_bundle(args.arch)
    mcfg = reduced_model(bundle.model) if args.reduced else bundle.model
    tcfg = dataclasses.replace(
        bundle.train,
        microbatch=args.microbatch,
        grad_compression=args.grad_compression,
        total_steps=args.steps,
        **({"learning_rate": args.lr} if args.lr else {}),
    )
    bundle = dataclasses.replace(bundle, model=mcfg, train=tcfg)
    dcfg = DataConfig(seq_len=args.seq_len, global_batch=args.global_batch)

    print(f"[train] arch={args.arch} reduced={args.reduced} steps={args.steps} "
          f"device={device} ckpt_dir={ckpt_dir}")
    t0 = time.time()
    losses = []

    def log(step, metrics):
        losses.append(metrics["loss"])
        if step % 10 == 0 or step == 1:
            print(f"  step {step:5d}  loss {metrics['loss']:.4f}  "
                  f"gnorm {metrics['grad_norm']:.3f}  lr {metrics['lr']:.2e}  "
                  f"({(time.time()-t0)/max(step,1):.2f}s/step)")

    train_loop(
        bundle, dcfg, args.steps, ckpt_dir,
        ckpt_every=args.ckpt_every, async_ckpt=True, on_metrics=log, device=device,
    )
    print(f"[train] done: first-10 mean loss {sum(losses[:10])/max(len(losses[:10]),1):.4f} "
          f"-> last-10 mean {sum(losses[-10:])/max(len(losses[-10:]),1):.4f}")
    return losses


if __name__ == "__main__":
    main()
