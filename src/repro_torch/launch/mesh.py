"""Production and local meshes.

Counterpart of ``repro.launch.mesh``, over ``core.distributed.Mesh``
(whose devices may repeat). Defined as functions, never module-level
constants, so importing this module never touches a device.

One controller lowers nothing for 256 or 512 chips: a production mesh is
abstract, its devices all ``torch.device("meta")`` — the axis names and
sizes the spec trees and the mesh-run MoE impls read, with no device
behind them.
"""

from __future__ import annotations

import torch

from repro_torch.core.distributed import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 single-pod (256 chips) or 2x16x16 multi-pod (512 chips) mesh,
    abstract (meta devices)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices=[torch.device("meta")] * (512 if multi_pod else 256))


def make_local_mesh(n_data: int | None = None, n_model: int = 1, devices=None) -> Mesh:
    """A (n_data, n_model) ("data", "model") mesh over ``devices`` (default:
    every CUDA device; never a quiet switch to the CPU). ``n_data`` defaults
    to the device count over ``n_model``; a device may repeat, e.g.
    ``devices=[torch.device("cpu")] * 8`` or ``[torch.device("cuda", 0)] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_local_mesh takes every CUDA device and no CUDA device is available; "
                "pass devices=, e.g. devices=[torch.device('cpu')] * 4"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    n_data = n_data if n_data is not None else n // n_model
    return make_mesh((n_data, n_model), ("data", "model"), devices=devices)
