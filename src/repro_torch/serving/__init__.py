from repro_torch.serving.config import GCConfig, PrefixConfig, ServeConfig
from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeConfig", "GCConfig", "PrefixConfig", "ServeEngine"]
