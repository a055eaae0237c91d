"""Decoder-only transformer, family ``dense`` with every layer ``A``
(port of the serving half of ``repro.models.transformer``).

Parameters are plain dicts of tensors with the JAX layouts, one dict per
layer under ``params["layers"]`` (the JAX package stacks them per pattern
group; ``models.convert`` unstacks).  Two entry points share them:

    prefill      — whole prompts, K/V scattered into the paged pools
    decode_step  — one token per sequence against the paged pools

The serving state is a dict: ``pos`` (B,), ``k_pages``/``v_pages``
(n_layers, num_pages, P, Hkv, D) and ``tables`` (B, 1, pages_per_seq).
The pools are updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import UnsupportedFeature
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import spec as pspec


def layer_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": layers.norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "ln2": layers.norm_spec(cfg), "mlp": layers.mlp_spec(cfg)}


class TransformerModel:
    """Dense decoder: global attention in every layer, gated or plain MLP."""

    def __init__(self, cfg: ModelConfig):
        if (set(cfg.pattern()) != {"A"} or cfg.is_moe or cfg.d_ff <= 0
                or cfg.activation not in layers.ACTIVATIONS):
            raise UnsupportedFeature(
                "the port runs dense all-'A' models with a silu/relu2 MLP; "
                f"pattern {cfg.layer_pattern!r}, activation "
                f"{cfg.activation!r} are still to be ported",
                pattern=cfg.layer_pattern, activation=cfg.activation)
        self.cfg = cfg
        self.n_attn_layers = cfg.n_layers

    # -- spec / params ----------------------------------------------------
    def param_spec(self) -> Dict:
        cfg = self.cfg
        return {"embed": layers.embed_spec(cfg),
                "ln_f": layers.norm_spec(cfg),
                "layers": [layer_spec(cfg) for _ in range(cfg.n_layers)]}

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Dict:
        return pspec.materialize(self.param_spec(), gen, dtype, device)

    # -- layer application --------------------------------------------------
    def _apply_ffn(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        return x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x),
                                    self.cfg)

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, params: Dict, tokens: torch.Tensor, state: Dict,
                lens: Optional[torch.Tensor] = None, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S) prompts (right-padded).  Returns (last-token
        logits (B, V), state with ``pos = lens``).  ``state["tables"]``
        must already map pages (the engine reserves before calling); the
        pools in ``state`` receive the prompts' K/V in place."""
        cfg = self.cfg
        B, S = tokens.shape
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
        x = layers.embed_tokens(params["embed"], tokens)
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            x = x + attn.attn_prefill(
                p["attn"], h, cfg, state["k_pages"][li], state["v_pages"][li],
                state["tables"], lens, impl=impl)
            x = self._apply_ffn(p, x)
        x = layers.apply_norm(params["ln_f"], x)
        last_idx = torch.clamp(lens.long() - 1, min=0)
        last = x[torch.arange(B, device=x.device), last_idx]
        logits = layers.unembed(params["embed"], last, cfg)
        return logits, dict(state, pos=lens)

    def decode_step(self, params: Dict, tokens: torch.Tensor, state: Dict,
                    impl: str = "kernel",
                    pages_per_block: Optional[int] = None,
                    num_splits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) → (logits (B, V), state with ``pos + 1``).  Each
        layer appends its K/V to the pools in place and attends over the
        pages through the block table."""
        cfg = self.cfg
        pos = state["pos"]
        x = layers.embed_tokens(params["embed"], tokens)
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            x = x + attn.attn_decode(
                p["attn"], h, cfg, state["k_pages"][li], state["v_pages"][li],
                state["tables"], pos, impl=impl,
                pages_per_block=pages_per_block, num_splits=num_splits)
            x = self._apply_ffn(p, x)
        x = layers.apply_norm(params["ln_f"], x)
        logits = layers.unembed(params["embed"], x, cfg)
        return logits, dict(state, pos=pos + 1)
