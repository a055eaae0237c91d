"""KV caches (port of ``repro.core.cache``): the paged pools with their
writes (whole prompts, prompt chunks, decode tokens), the page gather and
copy, and the contiguous max-length cache of the paper's baseline.

Pools are shaped (num_pages, page_size, kv_heads, head_dim) per layer and
shared by every sequence; a block-table row maps a sequence's logical
pages to physical ones.  Unlike the JAX package, which returns new pools,
the writes and `copy_page` **update the pools in place** and return
nothing (`write_decode` returns the cache it was given).

The contiguous cache (``ContiguousKVCache``) keeps one max-length buffer
per batch slot, head-major ``(n_layers, B, kv_heads, max_len, head_dim)``:
a token's K/V sit at its position, with no table and no ring.  Unlike the
JAX package's ``(.., max_len, kv_heads, ..)`` order, each (row, head) is
one contiguous (max_len, head_dim) matrix, so decode attention over it is
a strided batched product with no copy of the buffer.  Row lengths live
in the engine's ``pos``; the cache keeps none.

A write through a NULL page (-1) or past the table is dropped, as JAX's
``mode="drop"`` scatter drops it.  In PyTorch ``pages[-1] = x`` would
silently write the *last* page — another sequence's KV — so every write
is masked explicitly.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core import paging
from repro_torch.core.paging import PageState


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


def gather_layer(k_pages_l: torch.Tensor, v_pages_l: torch.Tensor,
                 tables: torch.Tensor, max_len: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg.1 GATHER: materialise (B, max_len, H, D) contiguous K/V from
    one layer's pools (new tensors; NULL pages read as zeros).

    ``tables``: (B, max_pages).  A reference path: the kernels read the
    pages in place.
    """
    ps = k_pages_l.shape[1]
    n_pages = -(-max_len // ps)
    tables = tables[:, :n_pages].long()
    safe = tables.clamp(0, k_pages_l.shape[0] - 1)
    live = (tables >= 0)[:, :, None, None, None]
    out = []
    for pool in (k_pages_l, v_pages_l):
        x = torch.where(live, pool[safe], torch.zeros((), dtype=pool.dtype,
                                                      device=pool.device))
        out.append(x.reshape(x.shape[0], -1, *x.shape[-2:])[:, :max_len])
    return out[0], out[1]


def copy_page(k_pages: torch.Tensor, v_pages: torch.Tensor, src_page,
              dst_page) -> None:
    """Copy one physical page across all layers, in place (fork's
    copy-on-write tail).  Pools: (L, num_pages, P, H, D); the pages are
    ints or 0-d tensors.  A NULL (or out-of-pool) source or destination
    is a no-op: the destination keeps its contents, and page -1 is never
    written."""
    n = k_pages.shape[1]
    dev = k_pages.device
    # (1,) index tensors: a 0-d one would be read on the host
    src = torch.as_tensor(src_page, device=dev).long().reshape(1)
    dst = torch.as_tensor(dst_page, device=dev).long().reshape(1)
    ok = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    s, d = src.clamp(0, n - 1), dst.clamp(0, n - 1)
    for pools in (k_pages, v_pages):
        pools[:, d] = torch.where(ok, pools[:, s], pools[:, d])


# ---------------------------------------------------------------------------
# The paged cache as one object (pools + the device-side PageState).
# ---------------------------------------------------------------------------
class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor  # (L, num_pages, page_size, kv_heads, head_dim)
    v_pages: torch.Tensor
    state: PageState

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]

    @property
    def num_pages(self) -> int:
        return self.k_pages.shape[1]


def init_cache(n_layers: int, num_pages: int, page_size: int, kv_heads: int,
               head_dim: int, max_seqs: int, max_pages_per_seq: int,
               dtype=torch.float32, *, device) -> PagedKVCache:
    shape = (n_layers, num_pages, page_size, kv_heads, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        state=paging.init_state(num_pages, max_seqs, max_pages_per_seq,
                                device=device))


def write_decode(cache: PagedKVCache, layer: int, seq_ids: torch.Tensor,
                 positions: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, window: int = 0) -> PagedKVCache:
    """Append one token per sequence at ``positions`` through the state's
    block tables (Alg.1 ASSIGN), in place on layer ``layer``'s pools.
    k_new/v_new: (B, kv_heads, head_dim).  Returns ``cache``."""
    write_layer_decode(cache.k_pages[layer], cache.v_pages[layer],
                       cache.state.block_tables[seq_ids.long()], positions,
                       k_new, v_new, window=window)
    return cache


# ---------------------------------------------------------------------------
# Contiguous (baseline) cache: the paper's comparison target.
# ---------------------------------------------------------------------------
class ContiguousKVCache(NamedTuple):
    """Max-length pre-allocated cache (the fragmenting baseline, §I)."""

    k: torch.Tensor  # (L, B, kv_heads, max_len, head_dim)
    v: torch.Tensor


def init_contiguous(n_layers: int, batch: int, max_len: int, kv_heads: int,
                    head_dim: int, dtype=torch.float32, *,
                    device) -> ContiguousKVCache:
    shape = (n_layers, batch, kv_heads, max_len, head_dim)
    return ContiguousKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device))


def write_contiguous_prefill(k_buf_l: torch.Tensor, v_buf_l: torch.Tensor,
                             slots: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> None:
    """Store prompts (B, S, H, D) at positions 0..S-1 of the buffer rows
    ``slots`` (B,) of (max_slots, H, max_len, D), in place: by position,
    never by ring.  Positions past a row's length receive its padding,
    which no read sees: decode writes each position before it attends
    over it."""
    S = k.shape[1]
    rows = slots.long()
    k_buf_l[rows, :, :S] = k.transpose(1, 2).to(k_buf_l.dtype)
    v_buf_l[rows, :, :S] = v.transpose(1, 2).to(v_buf_l.dtype)


def write_contiguous_decode(k_buf_l: torch.Tensor, v_buf_l: torch.Tensor,
                            positions: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor) -> None:
    """Store one token per buffer row of (B, H, max_len, D) at
    ``positions`` (B,), in place.  k_new/v_new: (B, H, D).  A position
    past the buffer is dropped, as the JAX scatter drops it."""
    B, S = k_buf_l.shape[0], k_buf_l.shape[2]
    rows = torch.arange(B, device=k_buf_l.device)
    inside = (positions < S)[:, None, None]
    at = positions.long().clamp(max=S - 1)
    for buf, new in ((k_buf_l, k_new), (v_buf_l, v_new)):
        # rows and at around a slice: the indexed view is (B, H, D)
        buf[rows, :, at] = torch.where(inside, new.to(buf.dtype),
                                       buf[rows, :, at])
