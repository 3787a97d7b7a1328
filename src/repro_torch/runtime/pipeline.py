"""Pipeline parallelism (gpipe-style) over one axis of a mesh.

Counterpart of ``repro.runtime.pipeline``. One controller drives
``n_stages`` stages, stage s on the s-th device along ``axis`` of a
``core.distributed.Mesh`` (the devices may repeat: four stages on one
card). Microbatches enter stage 0; in tick t stage s runs microbatch
t - s, and its output is copied to stage s + 1's device, the reference's
``ppermute``; after ``n_micro + n_stages - 1`` ticks every microbatch has
left the last stage. The reference also runs its stages on the bubbles'
fill (clipped microbatches, zeros) and drops what they give; here the
bubbles are skipped, which changes no output and no gradient.

Differentiable end to end: the copies between devices are autograd ops, so
``torch.autograd`` through ``pipeline_apply`` is the pipelined backward
(``tests/test_torch_pipeline.py`` holds it to the sequential composition).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.distributed import Mesh
from repro_torch.optim.adamw import tree_map


def _stage_devices(mesh: Mesh, axis: str) -> list:
    """The devices along ``axis`` (index 0 on every other axis)."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes are {mesh.axis_names}; no axis {axis!r} to pipeline over")
    k = mesh.axis_names.index(axis)
    line = mesh.devices[tuple(slice(None) if i == k else 0 for i in range(mesh.devices.ndim))]
    return list(line)


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x) -> y   (same shape both sides)
    stage_params,  # tree of tensors, leading dim = n_stages
    x_micro: torch.Tensor,  # (n_micro, mb, ...) inputs for stage 0
    mesh: Mesh,
    axis: str = "pod",
) -> torch.Tensor:
    """Returns the (n_micro, mb, ...) outputs of the final stage, on the
    last stage's device."""
    devices = _stage_devices(mesh, axis)
    n_stages, n_micro = len(devices), x_micro.shape[0]
    params = [tree_map(lambda p, s=s: p[s].to(devices[s]), stage_params)
              for s in range(n_stages)]
    inbox = [None] * n_stages  # what each stage takes in this tick
    outs = []
    for t in range(n_micro + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            m = t - s
            if not 0 <= m < n_micro:  # a bubble
                continue
            x_in = x_micro[m].to(devices[0]) if s == 0 else inbox[s]
            y = stage_fn(params[s], x_in)
            if s + 1 < n_stages:
                nxt[s + 1] = y.to(devices[s + 1])
            else:
                outs.append(y)  # microbatch m exits the last stage at tick m + P - 1
        inbox = nxt
    return torch.stack(outs)


def pipeline_loss(
    stage_fn: Callable,
    loss_fn: Callable,  # (y_final, target_micro) -> scalar (mean per microbatch)
    stage_params,
    x_micro: torch.Tensor,
    targets_micro: torch.Tensor,
    mesh: Mesh,
    axis: str = "pod",
) -> torch.Tensor:
    y = pipeline_apply(stage_fn, stage_params, x_micro, mesh, axis)
    t = targets_micro.to(y.device)
    return torch.mean(torch.stack([loss_fn(y[m], t[m]) for m in range(y.shape[0])]))
