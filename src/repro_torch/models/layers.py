"""Shared building blocks (port of ``repro.models.layers``)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_spec(cfg: ModelConfig) -> Dict:
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm (or LayerNorm with a bias), computed in f32."""
    xf = x.float()
    if "bias" in p:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    ms = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary positions
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation: x (..., H, D), positions (...,)."""
    if theta <= 0:
        return x
    D = x.shape[-1]
    half = D // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freqs  # (..., half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------
# the activations of the dense configs: SwiGLU (llama, granite) and
# squared ReLU (nemotron)
ACTIVATIONS = ("silu", "relu2")


def mlp_spec(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation == "silu":  # gated (SwiGLU)
        return {"wg": ParamSpec((d, f), ("embed", "mlp")),
                "wu": ParamSpec((d, f), ("embed", "mlp")),
                "wd": ParamSpec((f, d), ("mlp", "embed"))}
    return {"wu": ParamSpec((d, f), ("embed", "mlp")),
            "wd": ParamSpec((f, d), ("mlp", "embed"))}


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.activation == "silu":
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:  # relu2, checked when the model is built
        h = torch.square(F.relu(x @ p["wu"]))
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> Dict:
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.long()]


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = x @ w
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits
