"""KV page manager — the paper's Algorithm 1, on the device and on the host.

The device half is a port of the functional state machine of
``repro.core.paging``: the manager state (``PageState``) is a tuple of
fixed-shape tensors and every operation (``reserve``, ``free``, ``fork``,
``lookup``) is a pure function that returns new tensors, with vectorised
masked pops and pushes: no data-dependent shapes, no boolean-mask
indexing and no host sync, so a step can run it without waiting on the
card.  Sequence ids, lengths and page counts may be Python ints or 0-d
tensors on the state's device.

The host half, ``HostPageManager``, is a copy of
``repro.core.paging.HostPageManager``: true O(1) integer ops for the
scheduler's admission, preemption and release decisions, with a
list-based free stack.  The block tables it builds are shipped to the
device every step; the device pools (``core.cache``) hold the K/V.  Both
halves pop the free stack from its top and push freed pages in table
order, so the same operations leave the same stack, tables and refcounts
on either.

Prefix sharing: `fork` aliases the shared full pages and bumps refcounts
(copy-on-write); the unshared tail page is freshly allocated.  The
``cache`` hook is the global prefix cache (``core.prefix_cache``), which
registers itself there; ``reserve`` reclaims its detached pages on demand.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.errors import SchedulerInvariantError

NULL_PAGE = -1

Index = Union[int, torch.Tensor]


class PageState(NamedTuple):
    """Device-side allocator state (fixed-shape int32 tensors)."""

    free_stack: torch.Tensor  # (num_pages,) free physical page ids
    free_top: torch.Tensor  # () number of free pages on the stack
    refcount: torch.Tensor  # (num_pages,)
    block_tables: torch.Tensor  # (max_seqs, max_pages), NULL_PAGE = empty
    seq_lens: torch.Tensor  # (max_seqs,) tokens stored per sequence

    @property
    def num_pages(self) -> int:
        return self.free_stack.shape[0]

    @property
    def max_pages(self) -> int:
        return self.block_tables.shape[1]


def init_state(num_pages: int, max_seqs: int, max_pages_per_seq: int, *,
               device) -> PageState:
    i32 = dict(dtype=torch.int32, device=device)
    return PageState(
        free_stack=torch.arange(num_pages - 1, -1, -1, **i32),
        free_top=torch.tensor(num_pages, **i32),
        refcount=torch.zeros((num_pages,), **i32),
        block_tables=torch.full((max_seqs, max_pages_per_seq), NULL_PAGE,
                                **i32),
        seq_lens=torch.zeros((max_seqs,), **i32))


def pages_needed(n_tokens, page_size: int):
    return (n_tokens + page_size - 1) // page_size


def _i32(x: Index, state: PageState) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32,
                           device=state.free_stack.device)


def _at(x: Index, state: PageState) -> torch.Tensor:
    """An index as a (1,) tensor: indexing by a 0-d tensor would read its
    value on the host (``.item()``), a (1,) tensor indexes on the device."""
    return _i32(x, state).reshape(1).long()


def _row(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    return t[i][0]


def _set_row(t: torch.Tensor, i: torch.Tensor, row: torch.Tensor
             ) -> torch.Tensor:
    """``t`` with row ``i`` replaced (a new tensor)."""
    out = t.clone()
    out[i] = row[None]
    return out


def reserve(state: PageState, seq_id: Index, new_len: Index,
            page_size: int) -> PageState:
    """Grow sequence ``seq_id``'s reservation to cover ``new_len`` tokens
    (Alg.1 RESERVE).

    Pops the pages it needs from the free stack in one masked operation.
    On an exhausted pool the overflowing slots stay unchanged (callers
    check `has_capacity` first, the scheduler's admission control).
    """
    new_len = _i32(new_len, state)
    seq_id = _at(seq_id, state)
    row = _row(state.block_tables, seq_id)
    cur = pages_needed(_row(state.seq_lens, seq_id), page_size)
    tgt = pages_needed(new_len, page_size)
    slots = torch.arange(state.max_pages, dtype=torch.int32,
                         device=row.device)
    need = (slots >= cur) & (slots < tgt)
    rank = torch.cumsum(need.int(), 0, dtype=torch.int32) - 1
    avail = torch.minimum(need.int().sum(dtype=torch.int32), state.free_top)
    ok = need & (rank < avail)
    # the page for rank r is free_stack[free_top - 1 - r]
    idx = torch.clamp(state.free_top - 1 - rank, 0, state.num_pages - 1)
    popped = state.free_stack[idx.long()]
    new_row = torch.where(ok, popped, row)
    ref = state.refcount.index_add(
        0, torch.where(ok, popped, 0).long(), ok.int())
    return state._replace(
        block_tables=_set_row(state.block_tables, seq_id, new_row),
        free_top=state.free_top - avail,
        refcount=ref,
        seq_lens=_set_row(state.seq_lens, seq_id, new_len))


def free(state: PageState, seq_id: Index, page_size: int) -> PageState:
    """Release every page of ``seq_id`` (Alg.1's implicit FREE).

    Pages whose refcount drops to zero are pushed back on the free stack
    in table order; shared pages only lose one reference.
    """
    seq_id = _at(seq_id, state)
    row = _row(state.block_tables, seq_id)
    n_pages = pages_needed(_row(state.seq_lens, seq_id), page_size)
    slots = torch.arange(state.max_pages, dtype=torch.int32,
                         device=row.device)
    held = (slots < n_pages) & (row >= 0)
    safe_row = torch.where(held, row, 0).long()
    ref_after = state.refcount.index_add(0, safe_row, -held.int())
    releasable = held & (ref_after[safe_row] == 0)
    rank = torch.cumsum(releasable.int(), 0, dtype=torch.int32) - 1
    n_rel = releasable.int().sum(dtype=torch.int32)
    # slots that are not released push to one scratch slot past the stack
    push = torch.where(releasable, state.free_top + rank, state.num_pages)
    stack = torch.cat([state.free_stack, state.free_stack[:1]])
    stack = stack.scatter(0, push.long(), row)[:state.num_pages]
    return state._replace(
        free_stack=stack,
        free_top=state.free_top + n_rel,
        refcount=ref_after,
        block_tables=_set_row(state.block_tables, seq_id,
                              torch.full_like(row, NULL_PAGE)),
        seq_lens=_set_row(state.seq_lens, seq_id, _i32(0, state)))


def fork(state: PageState, src: Index, dst: Index, page_size: int
         ) -> Tuple[PageState, torch.Tensor]:
    """Prefix sharing: ``dst`` aliases ``src``'s *full* pages (refcount++)
    and gets a fresh page for the partial tail.  Returns (state,
    tail_src_page): the page whose K/V the cache copies into the fresh one
    (`core.cache.copy_page`), NULL_PAGE when ``src`` ends on a page edge.

    Callers check ``has_capacity(state, 1)`` first: the reserve has no
    failure channel, so a fork on a dry pool hands ``dst`` a NULL tail
    page (the host mirror refuses and rolls back instead).
    """
    src, dst = _at(src, state), _at(dst, state)
    src_len = _row(state.seq_lens, src)
    full = src_len // page_size
    src_row = _row(state.block_tables, src)
    slots = torch.arange(state.max_pages, dtype=torch.int32,
                         device=src_row.device)
    shared = slots < full
    ref = state.refcount.index_add(
        0, torch.where(shared, src_row, 0).long(), shared.int())
    state = state._replace(
        refcount=ref,
        block_tables=_set_row(state.block_tables, dst,
                              torch.where(shared, src_row, NULL_PAGE)),
        seq_lens=_set_row(state.seq_lens, dst, full * page_size))
    has_tail = src_len % page_size > 0
    tail = src_row[torch.clamp(full, max=state.max_pages - 1).reshape(1)
                   .long()][0]
    # without a tail the reserve below needs no page and changes nothing
    return (reserve(state, dst, src_len, page_size),
            torch.where(has_tail, tail, NULL_PAGE))


def has_capacity(state: PageState, n_pages: Index) -> torch.Tensor:
    return state.free_top >= n_pages


def used_pages(state: PageState) -> torch.Tensor:
    return state.num_pages - state.free_top


def lookup(state: PageState, seq_id: Index, pos: Index, page_size: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Logical position -> (physical page, offset) (Alg.1 lines 7-8)."""
    pos = _i32(pos, state)
    row = _row(state.block_tables, _at(seq_id, state))
    return row[(pos // page_size).reshape(1).long()][0], pos % page_size


class HostPageManager:
    """Python allocator for scheduling decisions.

    Interface mirrors Alg. 1; every op is O(pages touched) with O(1)
    amortised pops/pushes (list-based stack).
    """

    def __init__(self, num_pages: int, page_size: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self.free_list = list(range(num_pages - 1, -1, -1))
        self.refcount = [0] * num_pages
        self.tables: dict[int, list[int]] = {}
        self.lens: dict[int, int] = {}
        # global prefix cache hook (set by PrefixCache).  Cache residency
        # holds one refcount share per cached page, so the invariant
        # generalizes to
        #   refcount[p] == table occurrences of p + (1 if cache-resident)
        self.cache = None

    # -- Alg.1 RESERVE ----------------------------------------------------
    def reserve(self, seq_id: int, new_len: int) -> bool:
        row = self.tables.setdefault(seq_id, [])
        cur = len(row)
        tgt = -(-new_len // self.page_size)
        short = (tgt - cur) - len(self.free_list)
        if short > 0 and self.cache is not None:
            # pool pressure: evict LRU *detached* cached pages back onto
            # the free list before refusing — cached-but-unreferenced
            # pages are reclaimable capacity, not allocation
            self.cache.reclaim(short)
        if tgt - cur > len(self.free_list):
            return False  # admission control: caller must wait / preempt
        for _ in range(tgt - cur):
            p = self.free_list.pop()
            self.refcount[p] += 1
            row.append(p)
        self.lens[seq_id] = new_len
        return True

    def extend(self, seq_id: int, n_tokens: int = 1) -> bool:
        return self.reserve(seq_id, self.lens.get(seq_id, 0) + n_tokens)

    def free(self, seq_id: int) -> None:
        """Release all of ``seq_id``'s pages (refcount--; 0 => back on the
        free list).

        Double-free safe: freeing an unknown rid, or a page whose refcount
        is already zero, raises ``SchedulerInvariantError`` instead of
        silently corrupting the free list (the old behavior pushed the
        page twice, so two later sequences could be handed the same
        physical page — silent KV aliasing with no signal)."""
        if seq_id not in self.tables:
            raise SchedulerInvariantError(
                f"free of unknown rid {seq_id}: no table row — double free "
                "or never-reserved rid", rid=seq_id)
        for p in self.tables.pop(seq_id):
            if self.refcount[p] <= 0:
                raise SchedulerInvariantError(
                    f"double free of page {p} (refcount "
                    f"{self.refcount[p]}) while releasing rid {seq_id}",
                    rid=seq_id, page=p)
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self.free_list.append(p)
        self.lens.pop(seq_id, None)

    def fork(self, src: int, dst: int) -> bool:
        """Prefix sharing: dst aliases src's full pages (refcount++) and
        reserves a fresh tail page for src's partial page.

        All-or-nothing: if the pool cannot serve the tail page the shared
        refcount bumps are rolled back and ``False`` is returned — the
        caller must not admit the child.  (Silently keeping the bumps
        while the child has no tail row would let the child decode into a
        never-reserved page and desync refcounts from table occupancy.)

        Forking an unknown/freed ``src`` raises ``SchedulerInvariantError``
        with rid context (like ``free``) — the former bare ``KeyError``
        gave the caller no structured signal that it raced a
        free/preemption of the parent.
        """
        if src not in self.tables or src not in self.lens:
            raise SchedulerInvariantError(
                f"fork from unknown rid {src}: no table row — freed, "
                "preempted, or never reserved", rid=src)
        src_len = self.lens[src]
        full = src_len // self.page_size
        row = self.tables[src][:full]
        for p in row:
            self.refcount[p] += 1
        self.tables[dst] = list(row)
        self.lens[dst] = full * self.page_size
        if src_len % self.page_size:
            if not self.reserve(dst, src_len):
                # dry pool: undo the prefix aliasing entirely
                for p in row:
                    self.refcount[p] -= 1
                del self.tables[dst]
                del self.lens[dst]
                return False
        return True

    def clone(self) -> "HostPageManager":
        """Structural copy for speculative exploration (the replint model
        checker branches the allocator at every transition).  The cache
        hook is *not* carried over — ``PrefixCache.clone`` re-wires it so
        a clone never mutates the original's trie."""
        new = HostPageManager.__new__(HostPageManager)
        new.page_size = self.page_size
        new.num_pages = self.num_pages
        new.free_list = list(self.free_list)
        new.refcount = list(self.refcount)
        new.tables = {rid: list(row) for rid, row in self.tables.items()}
        new.lens = dict(self.lens)
        new.cache = None
        return new

    # -- accounting (paper's <5% overhead metric) -------------------------
    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self.free_list)

    @property
    def available_pages(self) -> int:
        """Pages servable on demand: the free list plus cached pages the
        prefix cache can evict (detached chains).  Capacity checks that
        look only at ``free_list`` under-admit when the cache is warm —
        a full-but-detached cache is reclaimable capacity."""
        n = len(self.free_list)
        if self.cache is not None:
            n += self.cache.reclaimable()
        return n

    def bytes_reserved(self, kv_heads: int, head_dim: int, n_layers: int,
                       itemsize: int = 2) -> int:
        per_page = self.page_size * kv_heads * head_dim * 2 * n_layers * itemsize
        return self.used_pages * per_page

    def bytes_theoretical_min(self, kv_heads: int, head_dim: int, n_layers: int,
                              itemsize: int = 2) -> int:
        tokens = sum(self.lens.values())
        return tokens * kv_heads * head_dim * 2 * n_layers * itemsize

    def overhead_frac(self, kv_heads: int = 1, head_dim: int = 1,
                      n_layers: int = 1) -> float:
        mn = self.bytes_theoretical_min(kv_heads, head_dim, n_layers)
        if mn == 0:
            return 0.0
        return self.bytes_reserved(kv_heads, head_dim, n_layers) / mn - 1.0
