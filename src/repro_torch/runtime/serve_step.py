"""Serving steps: prefill and decode (optionally ALSH-augmented).

Counterpart of ``repro.runtime.serve_step``. The steps are plain closures
over the configs (the port runs eagerly; there is nothing to jit).
``jit_decode_step``, which only attaches the reference's production
shardings, has no counterpart: one card holds the whole model.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import models
from repro_torch.configs.base import ModelConfig, RetrievalConfig
from repro_torch.runtime import retrieval as rt


def make_prefill_step(mcfg: ModelConfig, cache_len: Optional[int] = None):
    def prefill_step(params, batch):
        return models.forward_prefill(params, batch, mcfg, cache_len=cache_len)

    return prefill_step


def make_decode_step(
    mcfg: ModelConfig,
    rcfg: Optional[RetrievalConfig] = None,
    return_hidden: bool = False,
):
    """decode_step(params, batch, caches [, retrieval_state]) -> (logits, tok, caches).

    With ``return_hidden`` the step also returns the final hidden state,
    ``(logits, tok, caches, hidden)``: the one the lookup queried with, which
    a growing datastore's ``extend_datastore`` takes with the step's tokens.
    """

    if rcfg is None:

        def decode_step(params, batch, caches):
            return models.forward_decode(params, batch, caches, mcfg,
                                         return_hidden=return_hidden)

        return decode_step

    def decode_step_retr(params, batch, caches, retr_state: rt.RetrievalState):
        logits, _, new_caches, hidden = models.forward_decode(
            params, batch, caches, mcfg, return_hidden=True
        )
        knn_logp = rt.retrieve_logits(
            hidden, retr_state, rcfg, mcfg.vocab_size, weights=batch.get("retr_weights")
        )
        mixed = rt.interpolate(logits, knn_logp, rcfg.interp_lambda)
        next_tok = torch.argmax(mixed, dim=-1).to(torch.int32)
        if return_hidden:
            return mixed, next_tok, new_caches, hidden
        return mixed, next_tok, new_caches

    return decode_step_retr
