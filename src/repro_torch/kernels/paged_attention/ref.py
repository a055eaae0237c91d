"""Plain PyTorch oracle for paged decode attention (port of
``repro.kernels.paged_attention.ref``).

Implements Alg.1 GATHER + standard masked attention: materialise each
sequence's K/V from its pages, then softmax(q·Kᵀ)·V.  Also the split-K
oracle pair: ``paged_attention_partials_ref`` computes the per-partition
un-normalised ``(m, l, acc)`` partials over the page ranges
`decode_partition` assigns, and ``combine_partials_ref`` merges them.  Both
are K1's and K2's plain versions (``paged_attention.py``) behind the
oracle's ``(B, n_heads, head_dim)`` layout: one body per function.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels.paged_attention.paged_attention import (
    _combine_partials_plain, _paged_attention_partials_plain,
    ring_slot_positions)

__all__ = ["ring_slot_positions", "paged_attention_ref",
           "paged_attention_partials_ref", "combine_partials_ref"]


def paged_attention_ref(
    q: torch.Tensor,  # (B, n_heads, head_dim) — one query token per sequence
    k_pages: torch.Tensor,  # (num_pages, page_size, n_kv_heads, head_dim)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32, NULL = -1
    lens: torch.Tensor,  # (B,) int32 — cached tokens incl. the current one
    *,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
) -> torch.Tensor:
    B, n_heads, head_dim = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(head_dim)
    num_pages, page_size, n_kv, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    S = max_pages * page_size

    safe = torch.clamp(block_tables, 0, num_pages - 1).long()
    k = k_pages[safe].reshape(B, S, n_kv, head_dim)
    v = v_pages[safe].reshape(B, S, n_kv, head_dim)
    if kv_scale > 0:
        k = (k.float() * kv_scale).to(q.dtype)
        v = (v.float() * kv_scale).to(q.dtype)

    lens = lens.long()
    if window > 0:
        ring = -(-window // page_size) + 1
        pos = ring_slot_positions(lens, page_size, ring, S)
        live = (pos >= 0) & (pos < lens[:, None]) & (pos >= lens[:, None]
                                                     - window)
        # slots past the ring belong to the dense layers' pages
        slot_page = torch.arange(S, device=q.device) // page_size
        live &= (slot_page < ring)[None, :]
    else:
        pos = torch.arange(S, device=q.device)[None, :].expand(B, S)
        live = pos < lens[:, None]
    live &= (block_tables >= 0).repeat_interleave(page_size, dim=1)

    g = n_heads // n_kv
    qg = q.reshape(B, n_kv, g, head_dim) * scale
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.to(q.dtype)).float()
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)  # fully-masked rows
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(B, n_heads, head_dim).to(q.dtype)


def paged_attention_partials_ref(
    q: torch.Tensor,  # (B, n_heads, head_dim)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages)
    lens: torch.Tensor,  # (B,)
    *,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
    num_splits: int = 1,
    pages_per_block: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Split-K oracle: per-partition un-normalised softmax partials over
    the page ranges `decode_partition` assigns.  A wholly-dead partition
    yields (NEG_INF, 0, 0).  The body is K1's plain version
    (`paged_attention._paged_attention_partials_plain`); this entry takes
    the oracle's (B, n_heads, head_dim) query.

    Returns (m, l, acc) shaped ((B,Hkv,S,G), (B,Hkv,S,G), (B,Hkv,S,G,D)),
    f32.
    """
    B, n_heads, head_dim = q.shape
    n_kv = k_pages.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(head_dim))
    return _paged_attention_partials_plain(
        q.reshape(B, n_kv, n_heads // n_kv, head_dim), k_pages, v_pages,
        block_tables, lens, scale=scale, window=window, softcap=softcap,
        kv_scale=kv_scale, pages_per_block=pages_per_block,
        num_splits=num_splits)


def combine_partials_ref(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                         ) -> torch.Tensor:
    """Reference flash-decoding combine over the split axis (axis=2).

    m, l: (B, Hkv, S, G); acc: (B, Hkv, S, G, D).  Returns (B, H, D) f32.
    """
    o = _combine_partials_plain(m, l, acc)
    B, n_kv, g, D = o.shape
    return o.reshape(B, n_kv * g, D)
