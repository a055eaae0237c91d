"""Attention dispatch, one entry point per phase (port of
``repro.core.attention``, single-device paths).

  * ``prefill_attention`` — full-sequence causal attention for prompt
    prefill: the flex kernel K4 (``impl="kernel"``) or a dense plain path
    (``impl="ref"``, the JAX ``"jnp"`` path);
  * ``prefill_attention_paged`` — one prompt chunk per sequence against
    the paged KV pools (its K/V already written) through K3 and the
    combine (``impl="kernel"``) or the prefill oracle (``impl="ref"``);
  * ``decode_attention``  — one token against the paged KV pools through
    K1/K2 (``impl="kernel"``) or the plain oracle (``impl="ref"``).

All functions are GQA-aware.  ``impl`` is "kernel" (the default) or
"ref"; anything else raises ``EngineConfigError``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import flex
from repro_torch.kernels import check_impl
from repro_torch.kernels.flex_attention.ops import flex_attention
from repro_torch.kernels.paged_attention.ops import (paged_attention,
                                                     paged_prefill)


def prefill_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    lens: Optional[torch.Tensor] = None,
    causal: bool = True,
    impl: str = "kernel",
) -> torch.Tensor:
    """Full-sequence attention for prefill.  Returns (B, S, H, D).

    ``impl="kernel"`` runs the flex kernel over the mask
    ``causal ∧ padding(lens)``; ``impl="ref"`` the dense plain path.
    """
    check_impl(impl)
    mods = []
    if causal:
        mods.append(flex.sliding_window_mask(window) if window > 0
                    else flex.causal_mask)
    elif window > 0:
        mods.append(flex.sliding_window_mask(window))
    if lens is not None:
        mods.append(flex.padding_mask(lens))
    mask_mod = flex.and_masks(*mods) if mods else flex.full_mask
    score_mod = flex.softcap_score(softcap) if softcap > 0 else None

    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if impl == "kernel":
        out = flex_attention(qt, kt, vt, mask_mod=mask_mod,
                             score_mod=score_mod)
    else:
        out = _dense_attention(qt, kt, vt, mask_mod, score_mod)
    return out.transpose(1, 2)


def _dense_attention(q, k, v, mask_mod, score_mod):
    """(B,H,Q,D)x(B,Hkv,K,D) dense masked attention, f32 scores."""
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, Q, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev).reshape(Hkv, G)[None, :, :, None, None]
    qi = torch.arange(Q, device=dev)[None, None, None, :, None]
    ki = torch.arange(K, device=dev)[None, None, None, None, :]
    if score_mod is not None:
        s = score_mod(s, bi, hi, qi, ki)
    s = torch.where(mask_mod(bi, hi, qi, ki), s,
                    torch.tensor(-1e30, device=dev))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return out.reshape(B, H, Q, D)


def prefill_attention_paged(
    q: torch.Tensor,  # (B, C, H, D) — one prompt chunk per sequence
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages)
    kv_lens: torch.Tensor,  # (B,) cached tokens incl. the chunk
    q_start: torch.Tensor,  # (B,) absolute position of chunk token 0
    *,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
) -> torch.Tensor:
    """Chunked paged prefill attention, the prompt-phase counterpart of
    `decode_attention`: the chunk's K/V must already be in the pages
    (write-then-attend), and its queries attend causally over the cached
    prefix and the chunk itself through the block table.  Returns
    (B, C, H, D)."""
    return paged_prefill(q, k_pages, v_pages, block_tables, kv_lens,
                         q_start, softcap=softcap, impl=impl,
                         kv_scale=kv_scale, pages_per_block=pages_per_block,
                         num_splits=num_splits)


def decode_attention(
    q: torch.Tensor,  # (B, H, D) — one token per sequence
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages)
    lens: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
) -> torch.Tensor:
    """Paged decode attention, single device (the JAX local path).

    ``pages_per_block`` / ``num_splits`` are K1's KV-block width and
    split-K factor (None → auto-tuned, see
    `kernels.paged_attention.ops.choose_decode_params`).
    """
    return paged_attention(q, k_pages, v_pages, block_tables, lens,
                           window=window, softcap=softcap, impl=impl,
                           kv_scale=kv_scale,
                           pages_per_block=pages_per_block,
                           num_splits=num_splits)
