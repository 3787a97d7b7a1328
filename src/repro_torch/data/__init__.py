"""The synthetic training stream — counterpart of ``repro.data``."""

from repro_torch.data.pipeline import DataConfig, SyntheticStream

__all__ = ["DataConfig", "SyntheticStream"]
