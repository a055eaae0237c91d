"""Model registry: ``build_model(cfg)`` returns the family's model object."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import EngineConfigError
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.transformer import TransformerModel

# the families the port builds: every family of the JAX package
PORTED = ("dense", "moe", "vlm", "rglru", "xlstm", "encdec")


def build_model(cfg: ModelConfig):
    if cfg.family == "encdec":
        return EncDecModel(cfg)
    if cfg.family in PORTED:
        return TransformerModel(cfg)
    raise EngineConfigError(f"unknown family {cfg.family!r}",
                            family=cfg.family)
