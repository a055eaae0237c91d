"""GQA attention layer: projections + RoPE around the core attention ops
(port of ``repro.models.attention``, prefill and decode phases).

The paged KV pools are updated **in place**: ``attn_prefill`` and
``attn_decode`` scatter the new K/V into the pools they are given and
return only the layer output.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as core_attn
from repro_torch.core import cache as kvcache
from repro_torch.models.layers import apply_rope
from repro_torch.models.spec import ParamSpec


def attn_spec(cfg: ModelConfig) -> Dict:
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d), ("heads", None, "embed")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _qkv(p: Dict, x: torch.Tensor, positions: Optional[torch.Tensor],
         theta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def kv_quant(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Quantize K/V for pool storage (int8 mode); identity otherwise."""
    if cfg.kv_dtype != "int8":
        return x
    q = torch.round(x.float() / cfg.kv_scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def kv_pool_dtype(cfg: ModelConfig, dtype):
    return torch.int8 if cfg.kv_dtype == "int8" else dtype


def _out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    H, hd, d = p["wo"].shape
    return o.reshape(*o.shape[:-2], H * hd) @ p["wo"].reshape(H * hd, d)


def attn_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 tables: torch.Tensor, lens: torch.Tensor, *,
                 window: int = 0, impl: str = "kernel") -> torch.Tensor:
    """Prefill: attend over the prompt AND write K/V into the paged pools
    (in place).  ``tables``: (B, n_kv_shards, pages_per_shard)."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(p, x, pos, cfg.rope_theta)
    kvcache.write_layer_prefill(k_pages, v_pages, tables.reshape(B, -1),
                                kv_quant(cfg, k), kv_quant(cfg, v), lens,
                                window=window)
    o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                    impl=impl)
    return _out(p, o)


def attn_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                k_pages: torch.Tensor, v_pages: torch.Tensor,
                tables: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0, impl: str = "kernel",
                pages_per_block: Optional[int] = None,
                num_splits: Optional[int] = None) -> torch.Tensor:
    """Decode one token.  x: (B, d); positions: (B,) 0-based position of
    the incoming token; tables: (B, n_kv_shards, pages_per_shard).
    Appends K/V to the pools (in place), then attends over
    lens = positions + 1 tokens."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)  # (B, H/Hkv, hd)
    kvcache.write_layer_decode(k_pages, v_pages, tables, positions,
                               kv_quant(cfg, k), kv_quant(cfg, v),
                               window=window)
    o = core_attn.decode_attention(
        q, k_pages, v_pages, tables.reshape(B, -1),
        (positions + 1).to(torch.int32), window=window, impl=impl,
        kv_scale=cfg.kv_scale if cfg.kv_dtype == "int8" else 0.0,
        pages_per_block=pages_per_block, num_splits=num_splits)
    return _out(p, o)
