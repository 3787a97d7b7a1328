"""Fault-tolerant training loop: checkpoint/restart, failure injection,
straggler telemetry.

Counterpart of ``repro.runtime.fault``. The contract (held on the CPU by
``tests/test_torch_fault.py``, on the card by ``chip_smoke.py``'s ``train``
path under ``torch.use_deterministic_algorithms``):

  * deterministic data (pure function of step) + committed checkpoints ⇒
    a run killed at any step and restarted from the last COMMIT reproduces
    the uninterrupted run exactly (bit for bit on the CPU);
  * failures are injected as ``SimulatedFailure`` at arbitrary steps;
    ``run_with_restarts`` plays the coordinator: catch, restart from disk,
    resume. On a real cluster the coordinator is the job scheduler watching
    heartbeats — the restart path is identical.

Checkpoints hold the training state under the reference's leaf names
(``runtime.train_step.train_state_leaves``), so either package resumes the
other's run. A restore checks every leaf's shape and dtype against the
configuration's state before it loads any.

Straggler mitigation: per-step wall-time telemetry with an EWMA + k·sigma
outlier rule (``StragglerMonitor``). The serving tier shares the monitor as
its latency tracker.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from repro_torch import ckpt
from repro_torch.api.index import resolve_device
from repro_torch.configs.base import ArchBundle
from repro_torch.data.pipeline import DataConfig, SyntheticStream
from repro_torch.runtime.train_step import (
    init_train_state,
    make_train_step,
    train_state_from_leaves,
    train_state_leaves,
)


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / chaos drills)."""


@dataclass
class StragglerMonitor:
    """EWMA mean/variance over per-step (or per-request) durations.

    Two consumers share it: the training loop's straggler rule (``observe``
    flags k·sigma outliers WITHOUT folding them into the estimate — a
    straggler must not drag the baseline up), and the serving tier's latency
    tracker (``ewma_quantile`` — there ``k_sigma=inf`` so overload latencies
    DO update the estimate; an admission controller that ignored its own
    overload signal would never degrade).
    """

    alpha: float = 0.2
    k_sigma: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        if self.n >= 3:
            sd = max(self.var**0.5, 1e-6)
            if dt > self.mean + self.k_sigma * sd:
                self.flagged.append((step, dt))
                return True
        delta = dt - self.mean
        self.mean += self.alpha * delta
        self.var = (1 - self.alpha) * (self.var + self.alpha * delta * delta)
        self.n += 1
        return False

    def ewma_quantile(self, z: float = 2.326) -> float:
        """Normal-approximation EWMA quantile: ``mean + z·sd`` (z=2.326 is
        the 99th percentile). A smoothed tail estimate, not an exact order
        statistic — what an SLO admission controller wants: responsive to
        sustained shifts, calm about single spikes."""
        return self.mean + z * max(self.var, 0.0) ** 0.5


def restore_train_state(directory: str, step: int, template):
    """The committed ``step`` of ``directory`` as a ``TrainState`` shaped
    like ``template`` and on its device; raises naming the first leaf that
    is missing or differs in shape or dtype."""
    leaves = ckpt.restore_checkpoint(directory, step, list(train_state_leaves(template)))
    return train_state_from_leaves(leaves, template, device=template.opt.step.device)


def train_loop(
    bundle: ArchBundle,
    dcfg: DataConfig,
    steps: int,
    ckpt_dir: str,
    ckpt_every: int = 5,
    fail_at: Optional[int] = None,
    seed: int = 0,
    async_ckpt: bool = False,
    on_metrics: Optional[Callable[[int, dict], None]] = None,
    device=None,
):
    """Run (or resume) training to ``steps`` on ``device`` (default: the
    CUDA card). Raises SimulatedFailure at ``fail_at`` AFTER the step
    executes but BEFORE its checkpoint commits — the nastiest spot.
    Returns the final ``TrainState``."""
    dev = resolve_device(device)
    mcfg, tcfg = bundle.model, bundle.train
    stream = SyntheticStream(dcfg, mcfg)
    step_fn = make_train_step(mcfg, tcfg)

    template = init_train_state(seed, mcfg, tcfg, device=dev)
    start = ckpt.latest_step(ckpt_dir)
    if start is not None:
        state = restore_train_state(ckpt_dir, start, template)
        step = start
    else:
        state = template
        step = 0
        ckpt.save_checkpoint(ckpt_dir, 0, {k: ckpt.host_copy(v)
                                           for k, v in train_state_leaves(state).items()})
    del template

    monitor = StragglerMonitor()
    # the async saver is a context manager so an in-flight save is flushed
    # even when an exception (an injected SimulatedFailure) unwinds the
    # loop — otherwise the restart's latest_step read races the writer
    with contextlib.ExitStack() as stack:
        saver = None
        if async_ckpt:
            saver = stack.enter_context(ckpt.AsyncCheckpointer(ckpt_dir))
        while step < steps:
            batch = {k: torch.as_tensor(v).to(dev) for k, v in stream.batch(step).items()}
            t0 = time.monotonic()
            state, metrics = step_fn(state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}  # the sync ends the step
            monitor.observe(step, time.monotonic() - t0)
            step += 1
            if on_metrics:
                on_metrics(step, metrics)
            if fail_at is not None and step == fail_at:
                raise SimulatedFailure(f"injected failure at step {step}")
            if step % ckpt_every == 0 or step == steps:
                leaves = train_state_leaves(state)
                if saver is not None:
                    saver.save(step, leaves)
                else:
                    ckpt.save_checkpoint(ckpt_dir, step,
                                         {k: ckpt.host_copy(v) for k, v in leaves.items()})
    return state


def run_with_restarts(
    bundle: ArchBundle,
    dcfg: DataConfig,
    steps: int,
    ckpt_dir: str,
    failures: tuple = (),
    **kw,
):
    """Coordinator: restart from the last commit after each injected failure."""
    pending = list(failures)
    while True:
        fail_at = pending[0] if pending else None
        try:
            return train_loop(bundle, dcfg, steps, ckpt_dir, fail_at=fail_at, **kw)
        except SimulatedFailure:
            pending.pop(0)  # the "node" died; restart resumes from disk
