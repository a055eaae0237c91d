from repro_torch.models.api import build_model
from repro_torch.models.convert import params_from_numpy

__all__ = ["build_model", "params_from_numpy"]
