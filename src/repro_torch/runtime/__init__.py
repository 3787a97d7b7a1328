"""Runtime pieces of the port: so far only the failure type and the EWMA
monitor that the serving tier shares with the reference's training loop
(``runtime/fault.py``)."""

from repro_torch.runtime.fault import SimulatedFailure, StragglerMonitor

__all__ = ["SimulatedFailure", "StragglerMonitor"]
