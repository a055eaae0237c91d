"""PyTorch port: the global prefix cache against the JAX package — one
seeded sequence of reserve/attach/insert/reclaim/free/fork/clear ops on
the port's ``PrefixCache`` + ``HostPageManager`` and on the JAX ones gives
equal tables, refcounts, free lists, hits and evictions; and the port's
engine with ``prefix_cache=True`` gives the JAX engine's greedy tokens,
hits and allocator state with the cache cold, warm (monolithic and
chunked) and under eviction, and the same tokens as with the cache off."""

import jax
import numpy as np
import pytest

from repro.configs import get_smoke
from repro.core.paging import HostPageManager as JMgr
from repro.core.prefix_cache import PrefixCache as JCache
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core.paging import HostPageManager as TMgr
from repro_torch.core.prefix_cache import PrefixCache as TCache
from repro_torch.models import params_from_numpy
from repro_torch.serving import Engine, Request, Status


def _state(mgr, cache):
    return (list(mgr.free_list), list(mgr.refcount),
            {k: list(v) for k, v in mgr.tables.items()}, dict(mgr.lens),
            mgr.available_pages, cache.stats())


def _apply(obj, op, *args):
    try:
        return ("ok", getattr(obj, op)(*args))
    except Exception as e:  # the exception type is part of the decision
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_ops_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ps = 4
    heads = [rng.integers(0, 3, 3 * ps).tolist() for _ in range(3)]
    toks = {rid: heads[rid % 3] + rng.integers(0, 3, 2 * ps).tolist()
            for rid in range(10)}
    jm, tm = JMgr(20, ps), TMgr(20, ps)
    jc, tc = JCache(jm), TCache(tm)
    assert jm.cache is jc and tm.cache is tc
    for _ in range(300):
        op = rng.choice(["reserve", "attach", "insert", "reclaim", "free",
                         "fork", "clear"], p=[.25, .2, .2, .1, .15, .05,
                                              .05])
        rid, n, dst = (int(rng.integers(0, 10)), int(rng.integers(0, 21)),
                       10 + int(rng.integers(0, 3)))
        if op == "reserve":
            calls = [(m, "reserve", rid, n) for m in (jm, tm)]
        elif op == "attach":
            calls = [(c, "attach", rid, toks[rid], n) for c in (jc, tc)]
        elif op == "insert":
            calls = [(c, "insert", toks[rid], list(m.tables.get(rid, [])),
                      n) for c, m in ((jc, jm), (tc, tm))]
        elif op == "reclaim":
            calls = [(c, "reclaim", n % 6) for c in (jc, tc)]
        elif op == "free":
            calls = [(m, "free", rid) for m in (jm, tm)]
        elif op == "fork":
            calls = [(m, "fork", rid, dst) for m in (jm, tm)]
        else:
            calls = [(c, "clear") for c in (jc, tc)]
        ref, port = (_apply(*c) for c in calls)
        assert port == ref, (op, calls[1][1:])
        assert _state(tm, tc) == _state(jm, jc)
    assert tc.hits > 0 and tc.evicted_pages > 0  # the ops hit and evicted


@pytest.fixture(scope="module")
def jparams():
    return jbuild(get_smoke("llama2-7b")).init_params(jax.random.PRNGKey(7))


HEAD = [9] * 24  # a shared "system prompt" head: 3 pages of 8 tokens


def _engines(jparams, **knobs):
    """The JAX reference engine, the port's engine and the port's engine
    with the cache off, on shared weights."""
    knobs = dict(max_slots=2, max_seq_len=64, **knobs)
    jeng = JEngine(get_smoke("llama2-7b"), jparams, impl="ref",
                   rng=jax.random.PRNGKey(11), prefix_cache=True, **knobs)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    cfg = tget_smoke("llama2-7b")
    return (jeng, Engine(cfg, params, device="cpu", prefix_cache=True,
                         **knobs),
            Engine(cfg, params, device="cpu", **knobs))


def _waves(engines, waves):
    """Serve the waves one after another on every engine; the port's
    tokens, hits and allocator state must equal the reference's after
    each wave, and the cache-off port engine's tokens too."""
    jeng, eng, off = engines
    for wave in waves:
        out = []
        for e, R in ((jeng, JRequest), (eng, Request), (off, Request)):
            reqs = [R(prompt=list(p), max_new_tokens=n) for p, n in wave]
            e.generate(reqs, max_steps=500)
            out.append(reqs)
        ref, port, cold = out
        assert all(r.status is Status.FINISHED for r in port + cold)
        assert [r.output for r in port] == [r.output for r in ref]
        assert [r.output for r in cold] == [r.output for r in ref]
        assert ([r.cached_prefix for r in port]
                == [r.cached_prefix for r in ref])
        assert (_state(eng.mgr, eng.prefix_cache)
                == _state(jeng.mgr, jeng.prefix_cache))
        mem, jmem = eng.memory_report(), jeng.memory_report()
        for key in ("used_pages", "cached_pages", "reclaimable_pages",
                    "prefix_hit_tokens"):
            assert mem[key] == jmem[key], key
    return eng


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_warm_hits_equal_reference(jparams, chunk):
    """Wave 1 is cold; wave 2 attaches both requests to the cached head,
    runs only their tails (through the chunk path) and must match."""
    eng = _waves(_engines(jparams, prefill_chunk=chunk),
                 [[(HEAD + [1, 2, 3], 5)],
                  [(HEAD + [5] * 9, 5), (HEAD + [4, 5, 6, 7, 8], 4)]])
    assert eng.prefix_cache.hits >= 2
    assert eng.prefix_cache.hit_tokens >= 2 * len(HEAD)


def test_engine_eviction_equals_reference(jparams):
    """A cold admission against a pool the cache has absorbed: reserve
    evicts LRU detached pages mid-admission, losslessly."""
    eng = _waves(_engines(jparams, pool_tokens=64),
                 [[([3] * 40, 2)], [([4] * 56, 2)]])
    assert eng.prefix_cache.evicted_pages > 0
