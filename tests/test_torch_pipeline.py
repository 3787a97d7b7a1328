"""The port's pipeline parallelism (CPU): ``pipeline_apply`` and
``pipeline_loss`` against the sequential composition of the stages, forward
and gradients, at ``tests/test_pipeline.py``'s bar (forward rtol = atol =
1e-5; gradients rtol 1e-4, atol 1e-5).

The reference's own ``pipeline_apply`` fails on this host under jax 0.9.0
(ROADMAP.md Queue C item 2), so the ground truth is the sequential
composition: the port's own in torch, and the reference's stage function
composed in JAX (``jax.grad`` of its sequential loss) on the same numpy
inputs. The stages run on a mesh of CPU devices, which may repeat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core.distributed import make_mesh
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.runtime.pipeline import pipeline_apply, pipeline_loss

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DIM, MB = 16, 2


def _inputs(seed, n_stages, n_micro):
    rs = np.random.default_rng(seed)
    params = {"W": (rs.normal(size=(n_stages, DIM, DIM)) / DIM ** 0.5).astype(np.float32),
              "b": (rs.normal(size=(n_stages, DIM)) * 0.1).astype(np.float32)}
    x = rs.normal(size=(n_micro, MB, DIM)).astype(np.float32)
    tgt = rs.normal(size=(n_micro, MB, DIM)).astype(np.float32)
    return params, x, tgt


def _stage(p, h):
    return torch.tanh(h @ p["W"] + p["b"])


def _loss(y, t):
    return torch.mean((y - t) ** 2)


def _seq_forward(params, x, n_stages):
    h = x
    for s in range(n_stages):
        h = _stage({k: v[s] for k, v in params.items()}, h)
    return h


def _jax_reference(params, x, tgt, n_stages):
    """The sequential composition of the reference's stage in JAX: outputs
    and the gradients of the mean loss."""
    def stage(p, h):
        return jnp.tanh(h @ p["W"] + p["b"])

    def forward(p, xm):
        h = xm
        for s in range(n_stages):
            h = stage(jax.tree.map(lambda q: q[s], p), h)
        return h

    def loss(p):
        y = jax.vmap(lambda xm: forward(p, xm))(x)
        return jnp.mean(jax.vmap(lambda a, b: jnp.mean((a - b) ** 2))(y, tgt))

    jp = jax.tree.map(jnp.asarray, params)
    y = jax.vmap(lambda xm: forward(jp, xm))(jnp.asarray(x))
    return np.asarray(y), jax.tree.map(np.asarray, jax.grad(loss)(jp))


@pytest.mark.parametrize("n_stages,n_micro", [(4, 8), (4, 1), (2, 3), (1, 4), (4, 4)])
def test_pipeline_forward_and_grads_match_sequential(n_stages, n_micro):
    params, x, tgt = _inputs(n_stages * 10 + n_micro, n_stages, n_micro)
    mesh = make_mesh((n_stages,), ("pod",), devices=["cpu"] * n_stages)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx, tt = torch.as_tensor(x), torch.as_tensor(tgt)

    y_pipe = pipeline_apply(_stage, tp, tx, mesh, "pod")
    y_seq = torch.stack([_seq_forward(tp, tx[m], n_stages) for m in range(n_micro)])
    assert y_pipe.shape == (n_micro, MB, DIM)
    np.testing.assert_allclose(y_pipe.detach().numpy(), y_seq.detach().numpy(), **FWD_TOL)
    y_ref, g_ref = _jax_reference(params, x, tgt, n_stages)
    np.testing.assert_allclose(y_pipe.detach().numpy(), y_ref, **FWD_TOL)

    loss = pipeline_loss(_stage, _loss, tp, tx, tt, mesh, "pod")
    g_pipe = dict(zip(tp, torch.autograd.grad(loss, list(tp.values()))))
    seq = torch.mean(torch.stack([_loss(y, tt[m]) for m, y in enumerate(
        _seq_forward(tp, tx[m], n_stages) for m in range(n_micro))]))
    g_seq = dict(zip(tp, torch.autograd.grad(seq, list(tp.values()))))
    for k in tp:
        np.testing.assert_allclose(g_pipe[k].numpy(), g_seq[k].numpy(), err_msg=k, **GRAD_TOL)
        np.testing.assert_allclose(g_pipe[k].numpy(), g_ref[k], err_msg=k, **GRAD_TOL)


def test_pipeline_runs_on_one_axis_of_a_larger_mesh():
    """Stages along "pod" of a (2, 2) mesh: its devices at data index 0."""
    params, x, _ = _inputs(5, 2, 3)
    mesh = make_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    y = pipeline_apply(_stage, tp, torch.as_tensor(x), mesh, "pod")
    want = torch.stack([_seq_forward(tp, torch.as_tensor(x[m]), 2) for m in range(3)])
    np.testing.assert_allclose(y.numpy(), want.numpy(), **FWD_TOL)
    with pytest.raises(ValueError, match="no axis 'model'"):
        pipeline_apply(_stage, tp, torch.as_tensor(x), mesh, "model")


def test_pipeline_of_model_blocks_trains_like_the_blocks_in_sequence():
    """A stage that is a reduced gemma3-1b attention block (the stacked
    units' first layer): the pipelined loss's gradients equal the blocks'
    in sequence."""
    import dataclasses

    from repro_torch.configs import get_bundle, reduced_model
    from repro_torch.models import init_params
    from repro_torch.models.model import _apply_block_seq

    cfg = dataclasses.replace(reduced_model(get_bundle("gemma3-1b").model), n_units=2,
                              n_layers=14)
    units = init_params(0, cfg, device="cpu")["units"]["p0"]  # (2, ...) leaves: 2 stages
    stage_params = tree_map(lambda t: t.detach().requires_grad_(), units)
    live = tree_leaves(stage_params)
    rs = np.random.default_rng(3)
    x = torch.as_tensor(rs.normal(size=(3, 2, 8, cfg.d_model)).astype(np.float32))
    pos = torch.arange(8, dtype=torch.int32)[None].expand(2, 8)

    def stage(p, h):
        return _apply_block_seq("local", p, h, pos, cfg)

    mesh = make_mesh((2,), ("pod",), devices=["cpu", "cpu"])
    loss = pipeline_loss(stage, lambda y, t: torch.mean(y ** 2), stage_params, x, x, mesh)
    g_pipe = torch.autograd.grad(loss, live)

    def seq(m):
        h = x[m]
        for s in range(2):
            h = stage(tree_map(lambda t: t[s], stage_params), h)
        return torch.mean(h ** 2)

    g_seq = torch.autograd.grad(torch.mean(torch.stack([seq(m) for m in range(3)])), live)
    for a, b in zip(g_pipe, g_seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_TOL)
