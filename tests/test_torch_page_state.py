"""PyTorch port: the device-side page allocator (``core.paging.PageState``,
the paper's Alg. 1 as a state machine of fixed-shape tensors) against the
JAX package's ``repro.core.paging`` and the port's ``HostPageManager``.

- random reserve / extend / free / fork sequences: after every operation
  the port's state, the JAX state and the host manager hold the same
  tables, refcounts, free stack (``free_top`` and its live entries) and
  lengths;
- the cases of ``tests/test_paging.py``: reserve/free invariants, a
  reserve on a dry pool, fork sharing the full pages and giving a fresh
  tail, lookup;
- ``init_cache`` / ``write_decode`` (``PagedKVCache``) against the JAX
  ones;
- every operation, and ``copy_page`` on tensor pages, runs on meta
  tensors, which hold no data: no host sync (``.item()``), no
  boolean-mask indexing, no data-dependent shape.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import paging as jpaging
from repro_torch.core import cache as tcache
from repro_torch.core import paging
from repro_torch.core.paging import NULL_PAGE, HostPageManager

from _torch_helpers import t
from test_paging import device_invariants

PAGE = 8


def _same(state, jstate):
    for a, b in zip(state, jstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _same_as_host(state, mgr, live):
    top = int(state.free_top)
    assert state.free_stack[:top].tolist() == mgr.free_list
    assert state.refcount.tolist() == mgr.refcount
    for seq in live:
        n = -(-mgr.lens[seq] // PAGE)
        assert state.block_tables[seq, :n].tolist() == mgr.tables[seq]
        assert (state.block_tables[seq, n:] == NULL_PAGE).all()
        assert int(state.seq_lens[seq]) == mgr.lens[seq]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_ops_match_reference_and_host_manager(seed):
    """Reserve (new sequences), extend, free and fork on a 24-page pool
    of 6 sequences x 5 pages, the device ops applied where the host
    manager accepted them (as the scheduler guards them)."""
    rnd = random.Random(seed)
    num_pages, max_seqs, max_pages = 24, 6, 5
    mgr = HostPageManager(num_pages, PAGE)
    state = paging.init_state(num_pages, max_seqs, max_pages, device="cpu")
    jstate = jpaging.init_state(num_pages, max_seqs, max_pages)
    live = set()
    for _ in range(150):
        op = rnd.choice(["reserve", "extend", "free", "fork"])
        free_ids = [s for s in range(max_seqs) if s not in live]
        if op == "reserve" and free_ids:
            seq = rnd.choice(free_ids)
            n = rnd.randint(1, max_pages * PAGE)
            if mgr.reserve(seq, n):
                state = paging.reserve(state, seq, n, PAGE)
                jstate = jpaging.reserve(jstate, jnp.int32(seq),
                                         jnp.int32(n), PAGE)
                live.add(seq)
            else:
                mgr.tables.pop(seq, None)  # the refused row it left empty
        elif op == "extend" and live:
            seq = rnd.choice(sorted(live))
            by = rnd.randint(1, 9)
            if mgr.lens[seq] + by <= max_pages * PAGE and mgr.extend(seq,
                                                                     by):
                n = mgr.lens[seq]
                state = paging.reserve(state, torch.tensor(seq),
                                       torch.tensor(n), PAGE)
                jstate = jpaging.reserve(jstate, jnp.int32(seq),
                                         jnp.int32(n), PAGE)
        elif op == "free" and live:
            seq = rnd.choice(sorted(live))
            mgr.free(seq)
            state = paging.free(state, seq, PAGE)
            jstate = jpaging.free(jstate, jnp.int32(seq), PAGE)
            live.discard(seq)
        elif op == "fork" and live and free_ids:
            src, dst = rnd.choice(sorted(live)), rnd.choice(free_ids)
            if mgr.fork(src, dst):
                state, tail = paging.fork(state, src, dst, PAGE)
                jstate, jtail = jpaging.fork(jstate, jnp.int32(src),
                                             jnp.int32(dst), PAGE)
                assert int(tail) == int(jtail)
                live.add(dst)
        _same(state, jstate)
        _same_as_host(state, mgr, live)
        assert int(paging.used_pages(state)) == mgr.used_pages
    device_invariants(state, PAGE)


def test_reserve_free_invariants():
    rnd = random.Random(7)
    state = paging.init_state(32, 4, 8, device="cpu")
    lens = [0, 0, 0, 0]
    for _ in range(60):
        seq, length = rnd.randrange(4), rnd.randrange(61)
        need, have = -(-length // PAGE), -(-lens[seq] // PAGE)
        if length >= lens[seq]:
            if bool(paging.has_capacity(state, need - have)):
                state = paging.reserve(state, seq, length, PAGE)
                lens[seq] = length
        else:
            state = paging.free(state, seq, PAGE)
            lens[seq] = 0
        device_invariants(state, PAGE)


def test_reserve_on_a_dry_pool_leaves_the_pages_unmapped():
    state = paging.init_state(2, 2, 4, device="cpu")
    state = paging.reserve(state, 0, 2 * PAGE, PAGE)
    assert int(state.free_top) == 0
    state2 = paging.reserve(state, 1, PAGE, PAGE)
    assert int(state2.free_top) == 0
    assert (state2.block_tables[1] == NULL_PAGE).all()
    _same(state2, jpaging.reserve(jpaging.reserve(
        jpaging.init_state(2, 2, 4), jnp.int32(0), jnp.int32(2 * PAGE),
        PAGE), jnp.int32(1), jnp.int32(PAGE), PAGE))


def test_fork_shares_full_pages_and_copies_tail():
    state = paging.init_state(16, 4, 8, device="cpu")
    state = paging.reserve(state, 0, 2 * PAGE + 3, PAGE)
    state, tail = paging.fork(state, 0, 1, PAGE)
    t0, t1 = state.block_tables[0].tolist(), state.block_tables[1].tolist()
    assert t0[:2] == t1[:2]  # full pages shared
    assert t1[2] != t0[2] and t1[2] >= 0  # a fresh tail page
    assert int(tail) == t0[2]
    ref = state.refcount.tolist()
    assert ref[t0[0]] == ref[t0[1]] == 2 and ref[t0[2]] == ref[t1[2]] == 1
    state = paging.free(state, 1, PAGE)
    ref = state.refcount.tolist()
    assert ref[t0[0]] == ref[t0[1]] == 1 and ref[t1[2]] == 0
    device_invariants(state, PAGE)
    # a page-aligned source: no tail, NULL_PAGE returned, no page popped
    state = paging.reserve(paging.init_state(4, 2, 4, device="cpu"), 0,
                           2 * PAGE, PAGE)
    state, tail = paging.fork(state, 0, 1, PAGE)
    assert int(tail) == NULL_PAGE and int(state.free_top) == 2
    assert state.block_tables[1, :2].tolist() == state.block_tables[
        0, :2].tolist()


def test_lookup_translation():
    state = paging.init_state(8, 2, 4, device="cpu")
    state = paging.reserve(state, 0, 3 * PAGE, PAGE)
    page, off = paging.lookup(state, 0, 2 * PAGE + 5, PAGE)
    assert int(page) == int(state.block_tables[0, 2]) and int(off) == 5


def test_paged_kv_cache_write_decode_matches_reference():
    """``init_cache`` and ``write_decode`` through the state's tables, a
    'W' layer's ring and a sequence without pages (dropped)."""
    rng = np.random.default_rng(3)
    for window in (0, 16):
        cache = tcache.init_cache(2, 10, 8, 2, 4, 3, 4, device="cpu")
        jc = jcache.init_cache(2, 10, 8, 2, 4, 3, 4)
        for a, b in zip(cache[:2], jc[:2]):
            assert tuple(a.shape) == b.shape
        for seq, n in ((0, 30), (1, 9)):
            cache = cache._replace(state=paging.reserve(cache.state, seq, n,
                                                        8))
            jc = jc._replace(state=jpaging.reserve(jc.state, jnp.int32(seq),
                                                   jnp.int32(n), 8))
        seq_ids = np.array([0, 1, 2], np.int32)
        pos = np.array([29, 8, 0], np.int32)
        k = rng.standard_normal((3, 2, 4)).astype(np.float32)
        out = tcache.write_decode(cache, 1, t(seq_ids), t(pos), t(k), t(-k),
                                  window=window)
        assert out is cache
        jc = jcache.write_decode(jc, 1, jnp.asarray(seq_ids),
                                 jnp.asarray(pos), jnp.asarray(k),
                                 jnp.asarray(-k), window=window)
        np.testing.assert_array_equal(cache.k_pages.numpy(),
                                      np.asarray(jc.k_pages))
        np.testing.assert_array_equal(cache.v_pages.numpy(),
                                      np.asarray(jc.v_pages))


def test_state_machine_runs_on_meta_tensors():
    """Meta tensors have shapes and no data: an op that synced with the
    host or indexed by a boolean mask would raise here."""
    state = paging.init_state(16, 4, 8, device="meta")
    seq, n = (torch.tensor(v, device="meta") for v in (1, 20))
    state = paging.reserve(state, seq, n, PAGE)
    state, tail = paging.fork(state, seq, torch.tensor(2, device="meta"),
                              PAGE)
    state = paging.free(state, seq, PAGE)
    page, off = paging.lookup(state, seq, n, PAGE)
    cap = paging.has_capacity(state, 3)
    used = paging.used_pages(state)
    assert all(x.device.type == "meta" for x in (*state, tail, page, off,
                                                 cap, used))
    assert state.block_tables.shape == (4, 8) and tail.shape == ()
    pools = [torch.empty((2, 16, PAGE, 2, 4), device="meta")
             for _ in range(2)]
    tcache.copy_page(*pools, tail, page)  # fork's copy, on tensor pages
