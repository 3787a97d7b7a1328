"""Runtime pieces of the port: training (``runtime/train_step.py``: the
step and the named leaves of its state; ``runtime/fault.py``: the
checkpointed loop, failure injection and the EWMA monitor the serving tier
shares; ``runtime/pipeline.py``: the pipelined stages), the LM serving
steps (``runtime/serve_step.py``) and the ALSH retrieval attachment
(``runtime/retrieval.py``)."""

from repro_torch.runtime.fault import SimulatedFailure, StragglerMonitor
from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step
from repro_torch.runtime.train_step import (
    TrainState,
    init_train_state,
    make_train_step,
    train_state_from_leaves,
    train_state_leaves,
)

__all__ = [
    "SimulatedFailure",
    "StragglerMonitor",
    "TrainState",
    "init_train_state",
    "make_decode_step",
    "make_prefill_step",
    "make_train_step",
    "train_state_from_leaves",
    "train_state_leaves",
]
