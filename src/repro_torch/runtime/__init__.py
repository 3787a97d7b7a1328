"""Runtime pieces of the port: the failure type and the EWMA monitor that
the serving tier shares with the reference's training loop
(``runtime/fault.py``), the LM serving steps (``runtime/serve_step.py``) and
the ALSH retrieval attachment (``runtime/retrieval.py``)."""

from repro_torch.runtime.fault import SimulatedFailure, StragglerMonitor
from repro_torch.runtime.serve_step import make_decode_step, make_prefill_step

__all__ = ["SimulatedFailure", "StragglerMonitor", "make_decode_step", "make_prefill_step"]
