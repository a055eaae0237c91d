"""PyTorch port: fork with copy-on-write (``Engine.fork_request``,
``core.cache.copy_page``) against the JAX package.

- ``copy_page`` (``test_attention_core.py::test_copy_page_copy_on_write``):
  one page across all layers, in place; a NULL source or destination is a
  no-op and never writes page -1;
- ``test_engine.py::test_fork_prefix_sharing_is_exact_and_copy_on_write``:
  at most one new page per fork, the child's greedy tokens equal a fresh
  request with the same prefix and the JAX engine's forked child, the
  parent's equal a run without the fork;
  ``::test_fork_exceeding_max_seq_len_raises``;
- ``test_scheduler_preempt.py::test_fork_on_dry_pool_rolls_back`` on the
  port's ``HostPageManager``, and the engine's dry-pool refusal leaving
  no trace;
- fork with the prefix cache on (the cache's refcount invariants, tokens
  against the JAX engine), and fork of an 'RA' model, whose child starts
  from a copy of the parent's recurrent state;
- the refusals: a request that is not RUNNING, the baseline, windowed
  models (``InvalidRequest``), and the JAX package's fault that the last
  refusal avoids (``test_jax_fork_on_a_windowed_model_corrupts_the_parent``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import cache as jcache
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core import cache as tcache
from repro_torch.core.paging import HostPageManager
from repro_torch.errors import InvalidRequest, PoolExhausted, RequestTooLong
from repro_torch.models import params_from_numpy
from repro_torch.serving import Engine, Request

from _torch_helpers import t
from test_prefix_cache import check_cache_invariants


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(cfg_name, key=11, **knobs):
    """A JAX reference engine and the port's engine on its weights."""
    jcfg = get_smoke(cfg_name[0]).replace(**cfg_name[1])
    tcfg = tget_smoke(cfg_name[0]).replace(**cfg_name[1])
    jeng = JEngine(jcfg, impl="ref", rng=jax.random.PRNGKey(key), **knobs)
    tp = params_from_numpy(_np(jeng.params), device="cpu")
    return jeng, Engine(tcfg, tp, device="cpu", **knobs), tcfg, tp


LLAMA = ("llama2-7b", {})


def _until(eng, req, n):
    while len(req.output) < n:
        eng.step()


def _drain(eng, reqs):
    for _ in range(500):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.status.value == "finished" for r in reqs)


def _fresh(tcfg, tp, prompt, new, **knobs):
    eng = Engine(tcfg, tp, device="cpu", max_slots=1, max_seq_len=96,
                 **knobs)
    return eng.generate([Request(prompt=list(prompt),
                                 max_new_tokens=new)])[0].output


def test_copy_page_copy_on_write():
    rng = np.random.default_rng(0)
    shape = (2, 6, 4, 2, 8)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    jc = jcache.init_cache(n_layers=2, num_pages=6, page_size=4, kv_heads=2,
                           head_dim=8, max_seqs=2, max_pages_per_seq=3)
    jc = jc._replace(k_pages=jnp.asarray(kp), v_pages=jnp.asarray(vp))
    for src, dst in ((1, 4), (-1, 2), (3, -1), (torch.tensor(5),
                                                 torch.tensor(0))):
        k, v = t(kp), t(vp)
        tcache.copy_page(k, v, src, dst)
        ref = jcache.copy_page(jc, jnp.int32(int(src)), jnp.int32(int(dst)))
        np.testing.assert_array_equal(k.numpy(), np.asarray(ref.k_pages))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref.v_pages))
        if min(int(src), int(dst)) < 0:  # a no-op: page -1 untouched
            np.testing.assert_array_equal(k.numpy(), kp)


def test_fork_prefix_sharing_is_exact_and_copy_on_write():
    """Paper §III contribution 1: fork aliases full pages (no recompute,
    no copy), and the forked branch produces what a fresh request with the
    same prefix would; the parent is unaffected."""
    jeng, eng, tcfg, tp = _pair(LLAMA, max_slots=3, max_seq_len=96)
    outs = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        parent = R(prompt=[5] * 20, max_new_tokens=24)
        e.add_request(parent)
        _until(e, parent, 12)
        pages_before = e.mgr.used_pages
        child = e.fork_request(parent, max_new_tokens=6)
        # alias accounting: at most one fresh (tail) page
        assert e.mgr.used_pages - pages_before <= 1
        assert child.status.value == "running" and child.parent == parent.rid
        seq_at_fork = list(child.prompt)
        _drain(e, [parent, child])
        outs.append((seq_at_fork, parent.output, child.output))
    (jseq, jpar, jchild), (seq, par, child) = outs
    assert (seq, par, child) == (jseq, jpar, jchild)
    assert child == _fresh(tcfg, tp, seq, 6)
    assert par == _fresh(tcfg, tp, [5] * 20, 24)
    assert eng.mgr.used_pages == 0


def test_fork_exceeding_max_seq_len_raises():
    eng = Engine(tget_smoke("llama2-7b"), device="cpu", max_slots=3,
                 max_seq_len=32)
    parent = Request(prompt=[1] * 20, max_new_tokens=4)
    eng.add_request(parent)
    eng.step()
    with pytest.raises(RequestTooLong, match="max_seq_len"):
        eng.fork_request(parent, max_new_tokens=32)
    assert set(eng.mgr.tables) == {parent.rid}


def test_fork_on_dry_pool_rolls_back():
    """The host manager's fork is all-or-nothing; the engine refuses a
    fork it cannot serve before it touches anything."""
    mgr = HostPageManager(num_pages=3, page_size=4)
    assert mgr.reserve(0, 9)  # 2 full pages + a partial tail: pool dry
    before_ref = list(mgr.refcount)
    assert mgr.fork(0, 1) is False
    assert 1 not in mgr.tables and 1 not in mgr.lens
    assert mgr.refcount == before_ref
    assert len(mgr.free_list) == 0
    mgr2 = HostPageManager(num_pages=2, page_size=4)
    assert mgr2.reserve(0, 8)  # page-aligned: no tail, forks on a dry pool
    assert mgr2.fork(0, 1) is True
    assert mgr2.tables[1] == mgr2.tables[0]
    assert all(mgr2.refcount[p] == 2 for p in mgr2.tables[0])

    # the engine: a 3-page pool, the parent holds all of it
    eng = Engine(tget_smoke("llama2-7b"), device="cpu", max_slots=3,
                 max_seq_len=24, pool_tokens=24)
    parent = Request(prompt=[1] * 12, max_new_tokens=8)
    eng.add_request(parent)
    eng.step()
    assert eng.mgr.used_pages == 2 and eng.mgr.lens[parent.rid] == 13
    eng.mgr.reserve(parent.rid, 17)  # take the last page
    ref = list(eng.mgr.refcount)
    with pytest.raises(PoolExhausted, match="tail"):
        eng.fork_request(parent, max_new_tokens=2)
    assert eng.mgr.refcount == ref and set(eng.mgr.tables) == {parent.rid}
    assert len(eng.scheduler.running) == 1


def test_fork_with_the_prefix_cache():
    """A parent whose head pages the cache holds: the fork stacks its
    aliases on the cache's residency refcounts; the invariants hold after
    the fork and to the end, and both rows give the JAX engine's tokens."""
    ps = 8
    jeng, eng, _, _ = _pair(LLAMA, max_slots=3, max_seq_len=64,
                            prefix_cache=True)
    outs = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        e.generate([R(prompt=[6] * 3 * ps, max_new_tokens=2)])  # warm
        parent = R(prompt=[6] * 3 * ps + [7, 8, 9], max_new_tokens=10)
        e.add_request(parent)
        _until(e, parent, 3)
        assert parent.cached_prefix > 0
        child = e.fork_request(parent, max_new_tokens=5)
        check_cache_invariants(e.mgr, e.prefix_cache, e.scheduler)
        _drain(e, [parent, child])
        check_cache_invariants(e.mgr, e.prefix_cache, e.scheduler)
        outs.append((parent.output, child.output))
    assert outs[1] == outs[0]


def test_fork_copies_the_recurrent_state():
    """An 'RA' model (recurrent, no window): the child continues from a
    copy of the parent's R-layer state, so its greedy tokens equal a
    fresh request's on the same prefix and the JAX engine's child."""
    RA = ("recurrentgemma-9b", dict(layer_pattern="RA"))
    jeng, eng, tcfg, tp = _pair(RA, max_slots=2, max_seq_len=96)
    outs = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        parent = R(prompt=[3, 1, 4, 1, 5, 9, 2, 6] * 2, max_new_tokens=16)
        e.add_request(parent)
        _until(e, parent, 5)
        child = e.fork_request(parent, max_new_tokens=6)
        seq = list(child.prompt)
        _drain(e, [parent, child])
        outs.append((seq, parent.output, child.output))
    assert outs[1] == outs[0]
    seq, par, child = outs[1]
    assert child == _fresh(tcfg, tp, seq, 6)


def test_fork_refusals():
    eng = Engine(tget_smoke("llama2-7b"), device="cpu", max_slots=2,
                 max_seq_len=64)
    waiting = Request(prompt=[1] * 4, max_new_tokens=4)
    with pytest.raises(InvalidRequest, match="RUNNING"):
        eng.fork_request(waiting)
    a, b = (Request(prompt=[2] * 4, max_new_tokens=8) for _ in range(2))
    for r in (a, b):
        eng.add_request(r)
    eng.step()
    with pytest.raises(PoolExhausted, match="slot"):
        eng.fork_request(a, max_new_tokens=2)
    base = Engine(tget_smoke("llama2-7b"), device="cpu", paged=False,
                  max_slots=2, max_seq_len=64)
    r = Request(prompt=[2] * 4, max_new_tokens=8)
    base.add_request(r)
    base.step()
    with pytest.raises(InvalidRequest, match="paged"):
        base.fork_request(r)
    for kw in (dict(layer_pattern="W", window=16),
               dict(layer_pattern="AW", window=16)):
        win = Engine(tget_smoke("llama2-7b").replace(**kw), device="cpu",
                     max_slots=2, max_seq_len=64)
        r = Request(prompt=[2] * 20, max_new_tokens=8)
        win.add_request(r)
        win.step()
        with pytest.raises(InvalidRequest, match="window"):
            win.fork_request(r)
        assert list(win.mgr.tables) == [r.rid]


def test_jax_fork_on_a_windowed_model_corrupts_the_parent():
    """The JAX package's fault that the port refuses (the JAX package is
    not edited): ``fork_request`` aliases ``cached_len // P`` full pages,
    but a 'W' layer writes at column ``(pos // P) % ring``, one of the
    shared pages, so parent and child overwrite each other's K/V.  Smoke
    llama2-7b, pattern 'W', window 16, f32, ``PRNGKey(7)``, 3 slots,
    max_seq_len 96, a 3 x 96-token pool: a greedy parent on ``[5] * 20``
    with 40 new tokens, forked after 12 outputs into a child sampled at
    temperature 5.0, diverges from a fresh run of the same request."""
    cfg = get_smoke("llama2-7b").replace(layer_pattern="W", window=16)
    knobs = dict(max_slots=3, max_seq_len=96, pool_tokens=3 * 96)
    ref = JEngine(cfg, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    alone = ref.generate([JRequest(prompt=[5] * 20, max_new_tokens=40)])[0]
    eng = JEngine(cfg, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    parent = JRequest(prompt=[5] * 20, max_new_tokens=40)
    eng.add_request(parent)
    _until(eng, parent, 12)
    child = eng.fork_request(parent, max_new_tokens=20, temperature=5.0)
    for _ in range(200):
        if parent.done and child.done:
            break
        eng.step()
    first = next(i for i, (a, b) in enumerate(zip(parent.output,
                                                  alone.output)) if a != b)
    print(f"JAX fork on a 'W' model: the parent diverges from its run "
          f"alone at output {first}")
    assert parent.output[:12] == alone.output[:12] and first >= 12
    port = Engine(tget_smoke("llama2-7b").replace(layer_pattern="W",
                                                  window=16),
                  params_from_numpy(_np(eng.params), device="cpu"),
                  device="cpu", **knobs)
    p = Request(prompt=[5] * 20, max_new_tokens=40)
    port.add_request(p)
    _until(port, p, 12)
    with pytest.raises(InvalidRequest, match="window"):
        port.fork_request(p, max_new_tokens=20, temperature=5.0)
    _drain(port, [p])
    assert p.output == alone.output
