"""Model registry and input stand-ins (port of ``repro.models.api``).

``build_model(cfg)`` returns the family's model object.  ``input_specs(run)``
returns stand-ins for the data inputs of ``run``'s step, as tensors on
the ``meta`` device: shapes and dtypes, no memory.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
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


def input_specs(run: RunConfig, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Stand-ins for the data inputs of the step of ``run``, on ``meta``:

      train:   {"inputs", "targets"} (B, S) int32
      prefill: {"tokens"} (B, S), {"lens"} (B,) int32
      decode:  {"tokens"} (B,) int32 (the state comes from
               ``init_decode_state``)

    with the modality stubs of train and prefill in ``dtype``:
    ``frames`` (B, n_audio_frames, d_model) for ``encdec``,
    ``image_embeds`` (B, n_image_tokens, d_vision) for ``vlm``."""
    cfg = run.model
    B, S = run.global_batch, run.seq_len

    def stub(shape, dt=torch.int32):
        return torch.empty(shape, dtype=dt, device="meta")

    if run.kind == "train":
        out = {"inputs": stub((B, S)), "targets": stub((B, S))}
    elif run.kind == "prefill":
        out = {"tokens": stub((B, S)), "lens": stub((B,))}
    else:  # decode
        out = {"tokens": stub((B,))}
    if run.kind in ("train", "prefill"):
        if cfg.family == "encdec":
            out["frames"] = stub((B, cfg.n_audio_frames, cfg.d_model), dtype)
        if cfg.family == "vlm":
            out["image_embeds"] = stub((B, cfg.n_image_tokens, cfg.d_vision),
                                       dtype)
    return out
