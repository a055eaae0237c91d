"""Host-side KV page manager — the paper's Algorithm 1 on the host.

A copy of ``repro.core.paging.HostPageManager``: true O(1) integer ops
for the scheduler's admission, preemption and release decisions, with a
list-based free stack.  The block tables it builds are shipped to the
device every step; the device pools (``core.cache``) hold the K/V.

Prefix sharing: `fork` aliases the shared full pages and bumps refcounts
(copy-on-write); the unshared tail page is freshly allocated.  The
``cache`` hook is the global prefix cache (``core.prefix_cache``), which
registers itself there; ``reserve`` reclaims its detached pages on demand.
"""

from __future__ import annotations

from repro_torch.errors import SchedulerInvariantError

NULL_PAGE = -1


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
