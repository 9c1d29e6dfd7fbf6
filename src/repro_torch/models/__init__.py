from repro_torch.models.common import Runtime
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "Runtime", "build_model"]
