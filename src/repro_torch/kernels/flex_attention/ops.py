"""Public op: flex attention (the prefill path).

Builds the BlockMask the same way the JAX op does (analytic causal fast
path, the analytic windowed one for ``window > 0``, else the streaming
builder, batched for aux-carrying mods), pads to whole tiles and
dispatches to K4 or to the plain oracle.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import flex
from repro_torch.kernels import check_impl
from repro_torch.kernels.flex_attention.flex_attention import (
    flex_attention_kernel)
from repro_torch.kernels.flex_attention.ref import flex_attention_ref


def flex_attention(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, Hkv, K, D)
    v: torch.Tensor,
    *,
    mask_mod: flex.MaskMod = flex.causal_mask,
    score_mod: Optional[flex.ScoreMod] = None,
    block_mask: Optional[flex.BlockMask] = None,
    scale: Optional[float] = None,
    window: int = 0,
    impl: str = "kernel",
    q_block: int = 128,
    kv_block: int = 128,
) -> torch.Tensor:
    B, H, Q, D = q.shape
    K = k.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(D))

    check_impl(impl)
    if impl == "ref":
        return flex_attention_ref(q, k, v, mask_mod=mask_mod,
                                  score_mod=score_mod, scale=scale)

    q_block = min(q_block, Q)
    kv_block = min(kv_block, K)
    if block_mask is None:
        if mask_mod is flex.causal_mask:
            block_mask = flex.causal_block_mask(Q, K, q_block, kv_block,
                                                device=q.device)
        elif window > 0:
            block_mask = flex.causal_block_mask(Q, K, q_block, kv_block,
                                                window=window,
                                                device=q.device)
        else:
            # aux-carrying mods may be batch-dependent (padding and
            # document masks):
            # build a per-batch block mask, like create_block_mask(B=...)
            batched = isinstance(mask_mod, flex.AuxMod)
            block_mask = flex.build_block_mask(
                mask_mod, Q, K, q_block, kv_block, B=B if batched else None,
                device=q.device)

    pad_q = -Q % block_mask.q_block
    pad_k = -K % block_mask.kv_block
    if pad_q or pad_k:
        q = F.pad(q, (0, 0, 0, pad_q))
        k = F.pad(k, (0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, pad_k))

    out = flex_attention_kernel(
        q.contiguous(), k.contiguous(), v.contiguous(), block_mask,
        scale=scale, mask_mod=mask_mod, score_mod=score_mod, q_len=Q,
        kv_len=K)
    return out[:, :, :Q]
