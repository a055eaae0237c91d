"""Plain PyTorch oracle for flex attention: materialise the mask mod over
the full (Q, K) index space and run dense softmax attention with the
score mod applied (port of ``repro.kernels.flex_attention.ref``)."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import flex


def flex_attention_ref(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, Hkv, K, D)
    v: torch.Tensor,  # (B, Hkv, K, D)
    *,
    mask_mod: flex.MaskMod = flex.causal_mask,
    score_mod: Optional[flex.ScoreMod] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dev = q.device

    qg = q.reshape(B, Hkv, G, Q, D).float() * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev).reshape(Hkv, G)[None, :, :, None, None]
    qi = torch.arange(Q, device=dev)[None, None, None, :, None]
    ki = torch.arange(K, device=dev)[None, None, None, None, :]
    if score_mod is not None:
        s = score_mod(s, bi, hi, qi, ki)
    m = mask_mod(bi, hi, qi, ki)
    s = s.masked_fill(~m, float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, H, Q, D).to(q.dtype)
