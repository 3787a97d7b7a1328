"""ALSH retrieval attachment for LM serving (kNN-LM style).

Counterpart of ``repro.runtime.retrieval``. A datastore of (hidden-state key
→ next-token value) records is indexed with (d_w^l1, theta)-ALSH over
discretized reduced keys. At each decode step the model's final hidden
state queries the index under a per-query WEIGHT VECTOR (the paper's
setting: w rides with the query; by default the datastore's per-dimension
precision weights), and the retrieved neighbours' token distribution is
interpolated with the LM logits: log p = logaddexp(log((1-λ) p_LM),
log(λ p_kNN)).

The datastore index is a ``repro_torch.api`` :class:`Index`, so a lookup is
one ``index.query(q, w, spec)`` through the engine: on the card the weighted
``alsh_project`` and the fused ``gather_rerank_topk`` kernels (its
two-segment form for a growing datastore). A growing datastore
(``delta_capacity > 0``) takes new records through ``extend_datastore``.

The datastore is drawn from a CPU generator and moved to ``device``, so one
seed gives the same datastore on every device (the reference draws with
``jax.random``: parity goes through ``retrieval_state_from_jax``). The
scatter of neighbour probabilities onto token ids may add in any order on
the card (``index_put_`` with ``accumulate=True``), so kNN log-probs agree
with the reference's within a tolerance, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.api import Index, Planner, QualitySpec, QuerySpec, UpdateSpec
from repro_torch.api.index import as_generator, resolve_device
from repro_torch.configs.base import RetrievalConfig
from repro_torch.core import BoundedSpace, IndexConfig


class RetrievalState(NamedTuple):
    index: Index  # config-carrying ALSH index over the datastore keys
    values: torch.Tensor  # (n + delta_capacity,) int32 token ids of records
    proj: torch.Tensor  # (d_model, d_key) random key-reduction projection
    default_w: torch.Tensor  # (d_key,) default per-dimension weights


def query_spec(rcfg: RetrievalConfig):
    """The per-decode-step lookup spec this config asks for: a
    :class:`QualitySpec` (resolved through the plan memo ``build_datastore``
    filled) when ``rcfg.recall_target`` is set, else a :class:`QuerySpec`."""
    if rcfg.recall_target is not None:
        return QualitySpec(k=rcfg.topk, recall_target=rcfg.recall_target)
    return QuerySpec(k=rcfg.topk)


def index_config(rcfg: RetrievalConfig) -> IndexConfig:
    return IndexConfig(
        d=rcfg.d_key,
        M=rcfg.M,
        K=rcfg.K,
        L=rcfg.L,
        family=rcfg.family,
        max_candidates=rcfg.max_candidates,
        space=BoundedSpace(0.0, 1.0, float(rcfg.M)),
    )


def build_datastore(seed_or_generator, d_model: int, vocab: int, rcfg: RetrievalConfig,
                    device=None) -> RetrievalState:
    """Synthetic datastore (examples/tests); real deployments ingest hidden
    states from a corpus pass with the same machinery. Keys, values, the
    projection and the index's tables come from one CPU generator; the
    state lives on ``device`` (default: the CUDA card).

    With ``rcfg.delta_capacity > 0`` the index is built mutable and
    ``values`` is pre-sized for the delta slots, so the datastore can grow
    during serving (``extend_datastore``). With ``rcfg.recall_target`` the
    lookup plan is resolved now, calibrated on the datastore's own
    precision weights, so decode steps hit the memo."""
    gen = as_generator(seed_or_generator)
    dev = resolve_device(device)
    n, cap = rcfg.datastore_size, rcfg.delta_capacity
    keys = torch.rand((n, rcfg.d_key), generator=gen)
    values = torch.randint(0, vocab, (n,), generator=gen, dtype=torch.int32)
    values = torch.cat([values, torch.zeros((cap,), dtype=torch.int32)])
    proj = torch.randn((d_model, rcfg.d_key), generator=gen) / (d_model**0.5)
    # precision weights: inverse per-dim std of the datastore keys
    w = 1.0 / (torch.std(keys, dim=0, correction=0) + 1e-3)
    index = Index.build(gen, keys.to(dev), index_config(rcfg),
                        update=UpdateSpec(delta_capacity=cap), device=dev)
    if rcfg.recall_target is not None:
        index.plan(query_spec(rcfg), planner=Planner(weights=w))
    return RetrievalState(index=index, values=values.to(dev), proj=proj.to(dev),
                          default_w=w.to(dev))


def retrieval_state_from_jax(arrays: dict, rcfg: RetrievalConfig, device=None) -> RetrievalState:
    """The reference's ``RetrievalState`` as the port's: ``arrays`` holds the
    index leaves as ``Index.from_numpy`` takes them (with the delta leaves
    and tombstones of a mutable index) and ``values``, ``proj`` and
    ``default_w`` as numpy arrays. A quality-first config's plan is not
    handed over: ``index.plan`` resolves it again."""
    dev = resolve_device(device)
    index = Index.from_numpy(arrays, index_config(rcfg),
                             update=UpdateSpec(delta_capacity=rcfg.delta_capacity), device=dev)

    def t(name, dtype):
        return torch.from_numpy(np.array(arrays[name])).to(device=dev, dtype=dtype)

    return RetrievalState(index=index, values=t("values", torch.int32),
                          proj=t("proj", torch.float32), default_w=t("default_w", torch.float32))


def extend_datastore(state: RetrievalState, hidden: torch.Tensor,
                     values: torch.Tensor) -> tuple[RetrievalState, torch.Tensor]:
    """Streaming ingest: append (hidden-state, next-token) records.

    Args:
      state: datastore built with ``rcfg.delta_capacity > 0``.
      hidden: (m, d_model) hidden states — reduced with the datastore's own
        projection, then inserted into the delta segment.
      values: (m,) int32 next-token ids observed after those states.

    Returns (new state, (m,) assigned record ids; -1 where the delta was
    full — compact offline and rebuild). No host sync: a refused record's
    value goes to a scratch slot past the end, which is dropped.
    """
    index, ids = state.index.insert(reduce_key(hidden, state))
    n_slots = state.values.shape[0]
    slot = torch.where(ids >= 0, ids, n_slots).long()
    buf = torch.cat([state.values, state.values.new_zeros((1,))])
    buf[slot] = values.to(device=buf.device, dtype=torch.int32)
    return state._replace(index=index, values=buf[:n_slots]), ids


def retire_datastore(state: RetrievalState, ids) -> RetrievalState:
    """Tombstone datastore records (e.g. stale corpus spans) — retrieval
    stops returning them at once; space is reclaimed by a compact."""
    return state._replace(index=state.index.delete(ids))


def reduce_key(hidden: torch.Tensor, state: RetrievalState) -> torch.Tensor:
    """(B, d_model) hidden -> (B, d_key) in [0, 1] (sigmoid squash)."""
    return torch.sigmoid(hidden.float() @ state.proj)


def retrieve_logits(
    hidden: torch.Tensor,
    state: RetrievalState,
    rcfg: RetrievalConfig,
    vocab: int,
    weights: torch.Tensor | None = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """kNN log-probs (B, V) from ALSH neighbours of the hidden state."""
    return knn_logprobs(reduce_key(hidden, state), state, rcfg, vocab, weights, temperature)


def knn_logprobs(
    q: torch.Tensor,
    state: RetrievalState,
    rcfg: RetrievalConfig,
    vocab: int,
    weights: torch.Tensor | None = None,
    temperature: float = 1.0,
) -> torch.Tensor:
    """``retrieve_logits`` from reduced keys q (B, d_key): the lookup and the
    scatter, so two packages or devices can be handed the same keys."""
    B = q.shape[0]
    w = weights if weights is not None else state.default_w.expand(q.shape)
    res = state.index.query(q, w, query_spec(rcfg))
    # softmax(-d/T) over retrieved records, scattered onto their token ids
    valid = res.ids >= 0
    scores = torch.where(valid, -res.dists / temperature, -torch.inf)
    probs = torch.softmax(scores, dim=-1)  # (B, topk)
    tok = torch.where(valid, state.values[res.ids.clamp_min(0).long()], 0)
    pknn = torch.zeros((B, vocab), dtype=torch.float32, device=q.device)
    rows = torch.arange(B, device=q.device)[:, None].expand_as(tok)
    pknn.index_put_((rows, tok.long()), torch.where(valid, probs, 0.0), accumulate=True)
    return torch.log(pknn + 1e-20)


def interpolate(lm_logits: torch.Tensor, knn_logp: torch.Tensor, lam: float) -> torch.Tensor:
    """log((1-λ) p_LM + λ p_kNN) in a numerically stable form (the constants
    in f32, as the reference's)."""
    lm_logp = torch.log_softmax(lm_logits, dim=-1)
    log_keep = float(torch.log1p(torch.tensor(-lam, dtype=torch.float32)))
    log_lam = float(torch.log(torch.tensor(lam, dtype=torch.float32)))
    return torch.logaddexp(lm_logp + log_keep, knn_logp + log_lam)
