from repro_torch.serving.config import ServeConfig
from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeConfig", "ServeEngine"]
