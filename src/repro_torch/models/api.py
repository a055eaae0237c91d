"""Model registry: ``build_model(cfg)`` returns the family's model object."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.models.transformer import TransformerModel

# families the JAX package builds; the port has ported "dense" so far
FAMILIES = ("dense", "moe", "vlm", "rglru", "xlstm", "encdec")


def build_model(cfg: ModelConfig):
    if cfg.family == "dense":
        return TransformerModel(cfg)
    if cfg.family in FAMILIES:
        raise UnsupportedFeature(f"model family {cfg.family!r} is not "
                                 "ported yet (the port runs 'dense')",
                                 family=cfg.family)
    raise EngineConfigError(f"unknown family {cfg.family!r}",
                            family=cfg.family)
