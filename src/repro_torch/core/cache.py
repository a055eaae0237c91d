"""Paged KV cache writes (port of the serving half of ``repro.core.cache``:
whole prompts, prompt chunks, decode tokens).

Pools are shaped (num_pages, page_size, kv_heads, head_dim) per layer and
shared by every sequence; a block-table row maps a sequence's logical
pages to physical ones.  Unlike the JAX package, which returns new pools,
these functions **update the pools in place** and return nothing.

A write through a NULL page (-1) or past the table is dropped, as JAX's
``mode="drop"`` scatter drops it.  In PyTorch ``pages[-1] = x`` would
silently write the *last* page — another sequence's KV — so every write
is masked explicitly.
"""

from __future__ import annotations

import torch


def _scatter_tokens(pages: torch.Tensor, phys_pages: torch.Tensor,
                    offsets: torch.Tensor, vals: torch.Tensor) -> None:
    """In place: pages[phys, off] = vals, dropping NULL/out-of-pool pages.

    pages: (num_pages, P, H, D); phys/offsets: (...,); vals: (..., H, D).
    """
    flat_pages = phys_pages.reshape(-1).long()
    flat_off = offsets.reshape(-1).long()
    flat_vals = vals.reshape(-1, *vals.shape[-2:])
    keep = (flat_pages >= 0) & (flat_pages < pages.shape[0])
    pages[flat_pages[keep], flat_off[keep]] = flat_vals[keep].to(pages.dtype)


def write_layer_prefill(k_pages_l: torch.Tensor, v_pages_l: torch.Tensor,
                        tables: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, lens: torch.Tensor,
                        window: int = 0) -> None:
    """Scatter a full prompt (B, S, H, D) into one layer's pools, in place.

    ``tables``: (B, max_pages) physical pages per sequence.  Positions are
    0..S-1 per sequence; tokens past ``lens`` are dropped.  The one-chunk
    case of `write_layer_prefill_at`.
    """
    write_layer_prefill_at(k_pages_l, v_pages_l, tables, k, v,
                           torch.zeros_like(lens), lens, window=window)


def write_layer_decode(k_pages_l: torch.Tensor, v_pages_l: torch.Tensor,
                       tables: torch.Tensor, positions: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       window: int = 0) -> None:
    """Append one token per sequence at ``positions`` (Alg.1 ASSIGN), in
    place — the single-device branch of the JAX ``write_decode_sharded``.

    ``tables``: (B, n_kv_shards, pages_per_shard) or (B, max_pages);
    k_new/v_new: (B, kv_heads, head_dim).  Rows whose table entry is -1
    (dead or mid-prefill slots) write nothing.
    """
    page_size = k_pages_l.shape[1]
    t = tables.reshape(tables.shape[0], -1).long()
    logical = positions.long() // page_size
    if window > 0:
        ring = -(-window // page_size) + 1
        logical = logical % ring
    inside = logical < t.shape[1]
    phys = torch.gather(t, 1, torch.clamp(logical, max=t.shape[1] - 1)
                        [:, None])[:, 0]
    phys = torch.where(inside, phys, torch.full_like(phys, -1))
    off = positions.long() % page_size
    _scatter_tokens(k_pages_l, phys, off, k_new)
    _scatter_tokens(v_pages_l, phys, off, v_new)


def write_layer_prefill_at(k_pages_l: torch.Tensor, v_pages_l: torch.Tensor,
                           tables: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, start: torch.Tensor,
                           q_lens: torch.Tensor, window: int = 0) -> None:
    """Scatter a prompt *chunk* (B, C, H, D) into one layer's pools, in
    place — the chunked-prefill generalisation of `write_layer_prefill`.

    Chunk token ``i`` lands at absolute position ``start[b] + i``; tokens
    past ``q_lens`` (batch padding) are dropped.  ``start == 0`` and
    ``q_lens == lens`` is the whole-prompt scatter.  ``window > 0`` wraps
    the logical page over the ring and drops writes older than the ring
    capacity, so at most one write hits each (page, offset) slot.
    """
    B, C = k.shape[:2]
    ps = k_pages_l.shape[1]
    off_i = torch.arange(C, device=k.device)[None, :]
    pos = start.long()[:, None] + off_i
    logical = pos // ps
    valid = off_i < q_lens.long()[:, None]
    if window > 0:
        ring = -(-window // ps) + 1
        logical = logical % ring
        end = (start.long() + q_lens.long())[:, None]
        valid &= pos >= end - ring * ps
    valid &= logical < tables.shape[1]
    phys = torch.gather(tables.long(), 1,
                        torch.clamp(logical, max=tables.shape[1] - 1))
    phys = torch.where(valid, phys, torch.full_like(phys, -1))
    off = pos % ps
    _scatter_tokens(k_pages_l, phys, off, k)
    _scatter_tokens(v_pages_l, phys, off, v)
