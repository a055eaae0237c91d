"""Public ops: paged decode attention and chunked paged prefill (kernel or
oracle, GQA-aware).

``paged_attention(...)`` is the attention-over-pages op of decode:
``impl="kernel"`` runs K1 (split-K partials) and the combine (K2, at
every split count); ``impl="ref"`` runs the plain oracle.
``paged_prefill(...)`` is its chunked-prefill counterpart: K3 and the same
combine, or the prefill oracle.  Any other ``impl`` raises
``EngineConfigError``.

``choose_decode_params`` and ``choose_prefill_params`` keep the JAX
package's TPU-branch constants, so the port's partitions match the
reference split by split (tuning them for the H100 is separate work,
measured on the card).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import check_impl
from repro_torch.kernels.paged_attention.contracts import decode_partition
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_kernel, paged_prefill_kernel)
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_prefill_ref)

# KV tokens per KV block (the reference's MXU-width target).
_TARGET_BLOCK_TOKENS = 128
# Per-block K+V budget (bytes, f32-equivalent) bounding pages_per_block.
_KV_VMEM_BUDGET = 1 << 20
# Keep >= this many blocks per split; never exceed _MAX_SPLITS splits.
_MIN_BLOCKS_PER_SPLIT = 4
_MAX_SPLITS = 8
# Chunked-prefill Q-block sizing: score-tile rows (q_block·G) per Q-block.
_TARGET_Q_ROWS = 128


def choose_decode_params(
    max_pages: int,
    page_size: int,
    head_dim: int,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
) -> Tuple[int, int]:
    """Auto-tune ``(pages_per_block, num_splits)``.

    Block width targets ``_TARGET_BLOCK_TOKENS`` KV tokens, capped by the
    K+V budget; split-K grows with the block count but keeps at least
    ``_MIN_BLOCKS_PER_SPLIT`` blocks per split and at most ``_MAX_SPLITS``
    splits.  Explicit values pass through (clamped).  The combine runs
    as K2 at every split count.
    """
    if pages_per_block is None:
        target = max(1, _TARGET_BLOCK_TOKENS // max(1, int(page_size)))
        cap = max(1, _KV_VMEM_BUDGET // (2 * 4 * int(page_size)
                                         * max(1, int(head_dim))))
        pages_per_block = min(target, cap)
    ppb, n_blocks, _, _ = decode_partition(max_pages, pages_per_block)
    if num_splits is None:
        num_splits = min(max(1, n_blocks // _MIN_BLOCKS_PER_SPLIT),
                         _MAX_SPLITS)
    _, _, ns, _ = decode_partition(max_pages, ppb, num_splits)
    return ppb, ns


def paged_attention(
    q: torch.Tensor,  # (B, n_heads, head_dim)
    k_pages: torch.Tensor,  # (num_pages, page_size, n_kv_heads, head_dim)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32
    lens: torch.Tensor,  # (B,) int32
    *,
    scale: Optional[float] = None,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,  # >0: int8 pools, dequantized on the fly
    pages_per_block: Optional[int] = None,  # None → auto-tuned
    num_splits: Optional[int] = None,  # None → auto-tuned
) -> torch.Tensor:
    """Attention of one query token per sequence over its paged KV cache."""
    B, n_heads, head_dim = q.shape
    n_kv = k_pages.shape[2]
    page_size = k_pages.shape[1]
    max_pages = block_tables.shape[1]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(head_dim))

    check_impl(impl)
    if impl == "ref":
        return paged_attention_ref(
            q, k_pages, v_pages, block_tables, lens,
            scale=scale, window=window, softcap=softcap, kv_scale=kv_scale)

    ppb, ns = choose_decode_params(max_pages, page_size, head_dim,
                                   pages_per_block, num_splits)
    qg = q.reshape(B, n_kv, n_heads // n_kv, head_dim).contiguous()
    out = paged_attention_kernel(
        qg, k_pages, v_pages, block_tables, lens, scale=scale,
        window=window, softcap=softcap, kv_scale=kv_scale,
        pages_per_block=ppb, num_splits=ns)
    return out.reshape(B, n_heads, head_dim)


def choose_prefill_params(
    max_pages: int,
    page_size: int,
    head_dim: int,
    chunk: int,
    group: int,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
    q_block: Optional[int] = None,
) -> Tuple[int, int, int]:
    """Auto-tune ``(pages_per_block, num_splits, q_block)`` for K3.

    The KV-block width is the decode heuristic's.  Split-K defaults to
    **1**: the Q-block axis already multiplies the grid by
    ``ceil(chunk / q_block)``, so extra splits only pay the combine unless
    the caller asks for them.  ``q_block`` targets ``_TARGET_Q_ROWS`` rows
    and is clamped to the chunk.
    """
    ppb, ns = choose_decode_params(
        max_pages, page_size, head_dim, pages_per_block,
        1 if num_splits is None else num_splits)
    if q_block is None:
        q_block = max(1, _TARGET_Q_ROWS // max(1, int(group)))
    return ppb, ns, max(1, min(int(q_block), int(chunk)))


def paged_prefill(
    q: torch.Tensor,  # (B, C, n_heads, head_dim) — one prompt chunk per seq
    k_pages: torch.Tensor,  # (num_pages, page_size, n_kv_heads, head_dim)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32
    kv_lens: torch.Tensor,  # (B,) int32 cached tokens incl. the chunk
    q_start: torch.Tensor,  # (B,) int32 absolute position of chunk token 0
    *,
    scale: Optional[float] = None,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,  # None → auto-tuned
    num_splits: Optional[int] = None,  # None → 1
    q_block: Optional[int] = None,  # Q rows per Q-block (None → auto)
) -> torch.Tensor:
    """Chunked paged prefill: ``C`` query tokens per sequence attend
    causally over the sequence's paged KV cache (the prefix written by
    earlier chunks and the chunk's own causal part, all read through the
    block table).  See `ref.paged_prefill_ref` for the contract."""
    B, C, n_heads, head_dim = q.shape
    n_kv = k_pages.shape[2]
    scale = float(scale if scale is not None else 1.0 / math.sqrt(head_dim))

    check_impl(impl)
    if impl == "ref":
        return paged_prefill_ref(
            q, k_pages, v_pages, block_tables, kv_lens, q_start,
            scale=scale, softcap=softcap, kv_scale=kv_scale)

    ppb, ns, qb = choose_prefill_params(
        block_tables.shape[1], k_pages.shape[1], head_dim, C,
        n_heads // n_kv, pages_per_block, num_splits, q_block)
    return paged_prefill_kernel(
        q.contiguous(), k_pages, v_pages, block_tables, kv_lens, q_start,
        scale=scale, softcap=softcap, kv_scale=kv_scale,
        pages_per_block=ppb, num_splits=ns, q_block=qb)
