"""Config registry: one module per assigned architecture (+ the paper's own).

``get_config(name)`` returns the full production ModelConfig;
``get_smoke(name)`` the reduced CPU-testable variant.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, RunConfig, make_run

_MODULES = {
    "nemotron-4-340b": "repro_torch.configs.nemotron_4_340b",
    "granite-moe-1b-a400m": "repro_torch.configs.granite_moe_1b_a400m",
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
    "llama3-405b": "repro_torch.configs.llama3_405b",
    "nemotron-4-15b": "repro_torch.configs.nemotron_4_15b",
    "llama-3.2-vision-11b": "repro_torch.configs.llama_3_2_vision_11b",
    "whisper-medium": "repro_torch.configs.whisper_medium",
    "granite-8b": "repro_torch.configs.granite_8b",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma_9b",
    # the paper's own evaluation model (LLaMA-7B on FMS)
    "llama2-7b": "repro_torch.configs.llama2_7b",
}

ASSIGNED: List[str] = [k for k in _MODULES if k != "llama2-7b"]


def list_configs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return get_config(name).smoke()


__all__ = [
    "ASSIGNED",
    "INPUT_SHAPES",
    "ModelConfig",
    "RunConfig",
    "get_config",
    "get_smoke",
    "list_configs",
    "make_run",
]
