"""Global prefix cache: radix-indexed KV page sharing across requests (a
copy of ``repro.core.prefix_cache``).

PagedAttention's copy-on-write machinery (arxiv 2309.06180, §CoW sharing)
makes prefix reuse an *allocator* operation: two sequences whose token
prefixes agree can point their block tables at the same physical pages.
``HostPageManager.fork`` already does this for an explicit parent→child
fork; this module generalizes it to *any* pair of requests, vLLM
automatic-prefix-caching / SGLang radix-attention style:

  * every released request indexes its **full** pages into a radix trie
    keyed by ``page_size``-token chunks (the page's exact token content —
    a page is shareable only when every token in it matches, so the trie
    edge IS the hash);
  * admission walks the trie along the new prompt and *attaches* to the
    longest cached chain: each matched page is aliased into the request's
    table row (refcount++), ``mgr.lens``/``prefill_pos`` advance past the
    match, and prefill runs only the un-cached suffix through the
    prefix-aware chunk kernel — zero prefill work for the hit portion;
  * divergence needs no page copy at all: the match is page-granular, so
    the first differing token simply starts a *fresh* page (the partial
    tail is never shared — the same reason ``fork`` copies it).

Residency = one refcount share.  A cached page holds exactly one extra
reference for the trie, so ``mgr.free`` on the donor naturally *retains*
the page (refcount drops to ≥ 1, page stays off the free list) instead of
recycling it, and the allocator invariant generalizes cleanly::

    refcount[p] == occurrences of p across table rows + (1 if cached)

Eviction is LRU and refcount-aware: only chains no live request points at
(refcount == 1) are reclaimable, leaf-first so the trie never orphans an
interior node.  ``HostPageManager.reserve`` reclaims on demand when the
free list alone cannot serve a reservation, so a full cache is *capacity*,
not pressure — schedulers size admission against
``mgr.available_pages = free + reclaimable``.

Safety gates (enforced by the Engine): pages must be immutable once
written, so the cache is only enabled for paged, pure self-attention
models — no windowed layers (ring slots are overwritten in place), no
cross-attention/encdec (K/V depend on per-request image/audio context,
token-keyed sharing would be wrong), no recurrent layers (state is not
page-addressed).
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.errors import SchedulerInvariantError


class _Node:
    """One cached page: a trie edge labelled by the page's token content."""

    __slots__ = ("chunk", "page", "parent", "children", "last_use", "seq")

    def __init__(self, chunk: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], seq: int):
        self.chunk = chunk
        self.page = page
        self.parent = parent
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.last_use = 0
        self.seq = seq  # creation order: deterministic LRU tie-break

    def __repr__(self):  # pragma: no cover - debug aid
        return f"_Node(page={self.page}, children={len(self.children)})"


class PrefixCache:
    """Radix trie over cached KV pages, wired into a ``HostPageManager``.

    The cache owns one refcount share per resident page (residency is
    just another reference), so attach/insert/evict are pure integer
    bookkeeping on the host mirror — the device pools are untouched and
    the kernels gather shared pages through the block tables exactly as
    they gather private ones.

    ``faults`` (optional): a ``FaultPlan`` consulted at the ``attach``
    site — an injected ``evict`` models the cached chain disappearing
    between lookup and attach, and must degrade the admission to a plain
    cold prefill (gated by ``tests/test_faults.py``).
    """

    def __init__(self, manager, faults=None):
        self.mgr = manager
        self.faults = faults
        self.root = _Node((), -1, None, 0)
        self._page_node: Dict[int, _Node] = {}  # page id -> trie node
        self._clock = 0
        self._seq = 0
        # hit accounting (surfaced via Engine.robustness_report)
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.attach_faults = 0
        manager.cache = self  # reserve() reclaims through this hook

    # -- index ----------------------------------------------------------
    @property
    def resident_pages(self) -> int:
        return len(self._page_node)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, tokens: Sequence[int], max_tokens: int) -> List[_Node]:
        """Longest cached chain along ``tokens`` (≤ ``max_tokens``),
        page-granular.  Pure lookup: no refcounts touched."""
        ps = self.mgr.page_size
        limit = max(0, max_tokens) // ps
        nodes: List[_Node] = []
        node = self.root
        i = 0
        while len(nodes) < limit:
            chunk = tuple(tokens[i:i + ps])
            if len(chunk) < ps:
                break
            child = node.children.get(chunk)
            if child is None:
                break
            nodes.append(child)
            node = child
            i += ps
        return nodes

    # -- attach (admission-time hit) ------------------------------------
    def attach(self, rid: int, tokens: Sequence[int],
               max_tokens: int) -> int:
        """Alias the longest cached prefix of ``tokens`` into ``rid``'s
        table row and return the matched token count (0 = miss).

        On a hit the request's row starts as the shared chain (one
        refcount bump per page) with ``mgr.lens[rid]`` covering it; the
        caller reserves the suffix and runs prefill from the matched
        position.  ``max_tokens`` caps the match — admission passes
        ``total_len - 1`` so at least one position is always prefilled
        (sampling needs that position's logits).

        Rollback contract: if the caller cannot reserve the suffix it
        calls ``mgr.free(rid)`` — the shared pages keep their residency
        reference and stay cached; nothing leaks.
        """
        if rid in self.mgr.tables:
            raise SchedulerInvariantError(
                f"prefix attach for rid {rid} which already holds a table "
                "row — attach is an admission-time operation", rid=rid)
        nodes = self.match(tokens, max_tokens)
        if not nodes:
            self.misses += 1
            return 0
        if (self.faults is not None
                and self.faults.fire("attach", rid=rid) == "evict"):
            # injected race: the matched chain is evicted between lookup
            # and attach — the admission must degrade to a cold prefill
            self.attach_faults += 1
            self._evict_chain(nodes)
            self.misses += 1
            return 0
        now = self._tick()
        for nd in nodes:
            nd.last_use = now
            self.mgr.refcount[nd.page] += 1
        self.mgr.tables[rid] = [nd.page for nd in nodes]
        matched = len(nodes) * self.mgr.page_size
        self.mgr.lens[rid] = matched
        self.hits += 1
        self.hit_tokens += matched
        return matched

    # -- insert (index written pages) -----------------------------------
    def insert(self, tokens: Sequence[int], row: Sequence[int],
               written: int) -> int:
        """Index ``row``'s first ``written // page_size`` full pages under
        their token content; returns pages newly cached.

        Only *fully written* pages are indexed — a partial tail page is
        mutable (its free slots are still being filled) and never shared.
        Chunks already present keep the existing, content-identical page;
        the duplicate page is simply not indexed (it recycles normally
        when its owner frees).  Idempotent per (tokens, row).
        """
        ps = self.mgr.page_size
        n_full = min(written, len(tokens)) // ps
        node = self.root
        now = self._tick()
        added = 0
        for pi in range(min(n_full, len(row))):
            chunk = tuple(tokens[pi * ps:(pi + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                page = row[pi]
                if page in self._page_node:
                    break  # already indexed under another path; stop
                self._seq += 1
                child = _Node(chunk, page, node, self._seq)
                node.children[chunk] = child
                self._page_node[page] = child
                self.mgr.refcount[page] += 1  # the residency share
                self.inserted_pages += 1
                added += 1
            child.last_use = now
            node = child
        return added

    # -- eviction -------------------------------------------------------
    def _evict(self, node: _Node) -> None:
        """Drop one detached leaf: residency share released, page back on
        the free list."""
        assert not node.children and self.mgr.refcount[node.page] == 1
        self.mgr.refcount[node.page] = 0
        self.mgr.free_list.append(node.page)
        del node.parent.children[node.chunk]
        del self._page_node[node.page]
        self.evicted_pages += 1

    def _evict_chain(self, nodes: List[_Node]) -> None:
        """Evict a matched chain deepest-first, stopping at the first node
        still pinned (live reference or cached descendants)."""
        for nd in reversed(nodes):
            if nd.children or self.mgr.refcount[nd.page] != 1:
                break
            self._evict(nd)

    def reclaimable(self) -> int:
        """Pages evictable right now: refcount == 1 (no live reference)
        and every cached descendant also evictable (leaf-first order
        exists).  This is the cache's contribution to
        ``mgr.available_pages``."""
        count = 0

        def walk(node: _Node) -> bool:
            nonlocal count
            subtree_ok = True
            for c in node.children.values():
                subtree_ok = walk(c) and subtree_ok
            if node is self.root:
                return subtree_ok
            ok = subtree_ok and self.mgr.refcount[node.page] == 1
            if ok:
                count += 1
            return ok

        walk(self.root)
        return count

    def reclaim(self, n_pages: int) -> int:
        """Evict up to ``n_pages`` detached pages, least-recently-used
        leaves first, back onto the free list.  Returns pages freed.
        Attached chains (refcount ≥ 2) are untouchable — eviction can
        never race a live request off its pages."""
        heap: List[Tuple[int, int, _Node]] = []
        for nd in self._page_node.values():
            if not nd.children and self.mgr.refcount[nd.page] == 1:
                heap.append((nd.last_use, nd.seq, nd))
        heapq.heapify(heap)
        freed = 0
        while heap and freed < n_pages:
            _, _, nd = heapq.heappop(heap)
            if (nd.children or nd.page not in self._page_node
                    or self.mgr.refcount[nd.page] != 1):
                continue  # pinned or re-attached since queued
            parent = nd.parent
            self._evict(nd)
            freed += 1
            if (parent is not self.root and not parent.children
                    and self.mgr.refcount[parent.page] == 1):
                heapq.heappush(heap, (parent.last_use, parent.seq, parent))
        return freed

    def clear(self) -> int:
        """Evict everything evictable (detached chains); attached pages
        stay.  Returns pages freed."""
        return self.reclaim(len(self._page_node))

    def clone(self, manager) -> "PrefixCache":
        """Structural copy wired into ``manager`` (a cloned host mirror —
        see ``HostPageManager.clone``).  Trie topology, residency index,
        LRU clocks and counters are all copied; the clone registers
        itself as ``manager.cache`` and never touches the original."""
        new = PrefixCache.__new__(PrefixCache)
        new.mgr = manager
        new.faults = self.faults
        new.root = _Node((), -1, None, 0)
        new._page_node = {}
        new._clock = self._clock
        new._seq = self._seq
        new.hits = self.hits
        new.misses = self.misses
        new.hit_tokens = self.hit_tokens
        new.inserted_pages = self.inserted_pages
        new.evicted_pages = self.evicted_pages
        new.attach_faults = self.attach_faults

        def copy_children(src: _Node, dst: _Node) -> None:
            for chunk, child in src.children.items():
                c = _Node(chunk, child.page, dst, child.seq)
                c.last_use = child.last_use
                dst.children[chunk] = c
                new._page_node[child.page] = c
                copy_children(child, c)

        copy_children(self.root, new.root)
        manager.cache = new
        return new

    # -- reporting ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_tokens": self.hit_tokens,
            "resident_pages": self.resident_pages,
            "reclaimable_pages": self.reclaimable(),
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "attach_faults": self.attach_faults,
        }
