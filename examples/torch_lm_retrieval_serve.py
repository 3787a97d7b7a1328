"""End-to-end LM serving in the PyTorch port: a small LM answers a batch of
prompts, with ALSH retrieval augmentation on the decode path (kNN-LM style —
the paper's technique as a serving feature). The twin of
``examples/lm_retrieval_serve.py``, on the CUDA card by default.

    PYTHONPATH=src python examples/torch_lm_retrieval_serve.py [--arch gemma3-1b]
    PYTHONPATH=src python examples/torch_lm_retrieval_serve.py --device cpu --batch 2 \
        --prompt-len 16 --gen-len 4

The model is the architecture's reduced configuration with random
parameters. Both decodes start from the same prefill caches; each retrieval
step's output is checked to be a log-distribution that differs from the
plain step's.
"""

import argparse
import time

import torch

from repro_torch import models
from repro_torch.api.index import resolve_device
from repro_torch.configs import RetrievalConfig, get_bundle, reduced_model
from repro_torch.runtime import retrieval as rt
from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--device", default=None,
                    help="torch device; default the CUDA card (\"cpu\" runs the plain path)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mcfg = reduced_model(get_bundle(args.arch).model)
    rcfg = RetrievalConfig(datastore_size=8192, d_key=16, K=8, L=12, topk=8,
                           interp_lambda=0.25)
    params = models.init_params(0, mcfg, device=device)
    retr = rt.build_datastore(1, mcfg.d_model, mcfg.vocab_size, rcfg, device=device)
    # the datastore is a repro_torch.api Index — its config rides with it
    icfg = retr.index.config
    print(f"[serve] datastore index: n={retr.index.n} d={icfg.d} "
          f"family={icfg.family!r} K={icfg.K} L={icfg.L}")
    B, S, G = args.batch, args.prompt_len, args.gen_len

    prefill = make_prefill_step(mcfg, cache_len=S + G)
    decode_plain = make_decode_step(mcfg)
    decode_retr = make_decode_step(mcfg, rcfg)

    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, mcfg.vocab_size, (B, S), generator=gen, dtype=torch.int32)
    logits, caches = prefill(params, {"tokens": prompt.to(device)})
    tok = torch.argmax(logits, -1).to(torch.int32)
    _sync(device)
    print(f"[serve] arch={args.arch} (reduced) B={B} prompt={S} gen={G} on {device}")

    tokens = {}
    for name, step, extra in (
        ("plain", decode_plain, ()),
        ("ALSH-retrieval", decode_retr, (retr,)),
    ):
        t, c = tok, caches
        _sync(device)
        t0 = time.time()
        outs = []
        for i in range(G):
            batch = {"token": t, "pos": torch.full((B,), S + i, dtype=torch.int32,
                                                   device=device)}
            out, t, c = step(params, batch, c, *extra)
            outs.append(t)
        _sync(device)
        dt = (time.time() - t0) / G * 1e3
        tokens[name] = torch.stack(outs, dim=1).cpu()
        print(f"[serve] {name:16s}: {dt:6.1f} ms/step | first seq tokens: "
              f"{tokens[name][0, :10].tolist()}")

    # one step from the prefill caches both ways: the mixed output is a
    # log-distribution, and retrieval moved it off the LM's own
    batch = {"token": tok, "pos": torch.full((B,), S, dtype=torch.int32, device=device)}
    plain_logits, _, _ = decode_plain(params, batch, caches)
    mixed, _, _ = decode_retr(params, batch, caches, retr)
    mass = torch.logsumexp(mixed, dim=-1).exp()
    assert torch.allclose(mass, torch.ones_like(mass), atol=1e-3), mass
    assert not torch.allclose(torch.log_softmax(plain_logits, -1), mixed, atol=1e-4)
    print("[serve] retrieval weights ride with each query (paper's w): pass "
          "batch['retr_weights'] to bias which hidden dimensions matter.")
    return tokens


if __name__ == "__main__":
    main()
