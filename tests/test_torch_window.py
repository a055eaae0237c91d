"""PyTorch port: sliding-window ('W') models against the JAX package.

- the attend-then-write chunk of a 'W' layer
  (``prefill_attention_windowed_chunk``) and the ring writes at the wrap
  (``write_layer_prefill_at(..., window=)``, a chunk longer than the
  ring);
- the model's ``prefill``, ``prefill_chunk`` and ``decode_step`` logits
  (``LOGIT_TOL``) for every layer 'W' (window 16), 'A' and 'W' mixed
  (window 12) and the ``swa`` variant of llama2-7b (window 32), with the
  ring wrapping;
- the engine's greedy tokens against the JAX ``Engine(impl="ref")``,
  monolithic and chunked (8 and 13), decoding past the window, with equal
  ``pages_per_seq``, ``num_pages`` and ``memory_report``; the ring-table
  exemption of pure-'W' models; ``prefix_cache=True`` refused with a
  window; ``params_from_numpy`` on 'W' groups.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.configs.base import make_run as jmake_run
from repro.core import attention as jattn
from repro.core import cache as jcache
from repro.errors import EngineConfigError as JEngineConfigError
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.configs.base import make_run as tmake_run
from repro_torch.core import attention as tattn
from repro_torch.core import cache as tcache
from repro_torch.errors import EngineConfigError
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, t


def _configs(name):
    """(JAX config, port config) of a smoke llama2-7b variant."""
    if name == "swa":
        return tuple(mk(smoke("llama2-7b"), "decode_32k", "swa").model
                     .replace(window=32)
                     for mk, smoke in ((jmake_run, get_smoke),
                                       (tmake_run, tget_smoke)))
    kw = dict(W=dict(layer_pattern="W", window=16),
              AW=dict(layer_pattern="AW", window=12))[name]
    return get_smoke("llama2-7b").replace(**kw), tget_smoke(
        "llama2-7b").replace(**kw)


def _models(name, seed=0):
    jcfg, tcfg = _configs(name)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jm, jp, build_model(tcfg), tp


def _ring(cfg):
    return -(-cfg.window // cfg.page_size) + 1


# -- the chunk kernels' plain ops and the ring writes -------------------------
@pytest.mark.parametrize("softcap,int8", [(0.0, False), (20.0, False),
                                          (0.0, True)])
def test_windowed_chunk_equals_reference(softcap, int8):
    """Rows resume at 0 (nothing cached), inside the first ring and past
    several wraps; a dead row; a table wider than the ring (the mixed
    model's) with a -1 hole in an unwritten ring column."""
    rng = np.random.default_rng(3)
    B, C, H, Hkv, D, P, window = 4, 10, 4, 2, 16, 8, 20
    ring = -(-window // P) + 1
    num_pages = B * 6 + 2
    shape = (num_pages, P, Hkv, D)
    if int8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    tables = rng.permutation(num_pages)[:B * 6].reshape(B, 6).astype(
        np.int32)
    tables[1, 2:] = -1  # resumes at 13: ring columns 2.. never written
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    k_new = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, Hkv, D)).astype(np.float32)
    q_start = np.array([0, 13, 75, 40], np.int32)
    q_lens = np.array([10, 7, 10, 0], np.int32)
    kw = dict(window=window, softcap=softcap,
              kv_scale=0.05 if int8 else 0.0)
    ref = jattn.prefill_attention_windowed_chunk(
        *map(jnp.asarray, (q, k_new, v_new, kp, vp, tables, q_start,
                           q_lens)), **kw)
    got = tattn.prefill_attention_windowed_chunk(
        *map(t, (q, k_new, v_new, kp, vp, tables, q_start, q_lens)), **kw)
    assert ring == 4 and got.shape == (B, C, H, D)
    close(got, ref, ATTN_TOL)


@pytest.mark.parametrize("start", [0, 37, 101])
def test_ring_write_past_the_wrap_equals_reference(start):
    """A chunk longer than the ring (ring·P = 12 slots, 30 tokens): only
    its last ring·P positions land, one write per slot."""
    rng = np.random.default_rng(start)
    num_pages, page, H, D, B, C, window = 12, 4, 2, 8, 2, 30, 10
    ring = -(-window // page) + 1
    kp = rng.standard_normal((num_pages, page, H, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, H, D)).astype(np.float32)
    tables = rng.permutation(num_pages)[:B * ring].reshape(B, ring).astype(
        np.int32)
    k = rng.standard_normal((B, C, H, D)).astype(np.float32)
    v = rng.standard_normal((B, C, H, D)).astype(np.float32)
    st = np.array([start, start + 3], np.int32)
    q_lens = np.array([C, 25], np.int32)
    ref_k, ref_v = jcache.write_layer_prefill_at(
        *map(jnp.asarray, (kp, vp, tables, k, v, st, q_lens)),
        window=window)
    pk, pv = t(kp), t(vp)
    tcache.write_layer_prefill_at(pk, pv, *map(t, (tables, k, v, st,
                                                   q_lens)), window=window)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(ref_v))


# -- the model ----------------------------------------------------------------
def _state(cfg, B, pps, seed):
    """Zero pools and scattered tables (B, 1, pps), numpy."""
    num_pages = B * pps + 2
    tables = np.random.default_rng(seed).permutation(num_pages)[:B * pps]
    pool = (cfg.n_layers, num_pages, cfg.page_size, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    return np.zeros(pool, np.float32), tables.reshape(B, 1, pps).astype(
        np.int32)


def _width(cfg, tokens):
    """Table width: the ring for pure-'W' models, else every token."""
    if "A" not in cfg.pattern():
        return _ring(cfg)
    return -(-tokens // cfg.page_size)


@pytest.mark.parametrize("name", ["W", "AW", "swa"])
def test_model_prefill_and_decode_logits_match_reference(name):
    """Prompts longer than the window, then 12 teacher-forced decode steps
    (the ring wraps again), on the port's kernel path (K4's and K1's
    plain versions) and its oracle path."""
    jcfg, jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(5)
    B, steps = 3, 12
    lens = np.array([45, 20, 33], np.int32)
    S = int(lens.max())
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pool, tables = _state(jcfg, B, _width(jcfg, S + steps), 1)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens), impl="ref")
    ref, feed = [np.asarray(jl)], []
    for _ in range(steps):
        feed.append(rng.integers(0, jcfg.vocab_size, B).astype(np.int32))
        jl, jst = jm.decode_step(jp, jnp.asarray(feed[-1]), jst, impl="ref")
        ref.append(np.asarray(jl))
    for impl, knobs in (("kernel", dict(pages_per_block=1, num_splits=2)),
                        ("ref", {})):
        st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
              "v_pages": t(pool)}
        logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                                impl=impl)
        close(logits, ref[0], LOGIT_TOL)
        for i, tok in enumerate(feed):
            logits, st = tm.decode_step(tp, t(tok).long(), st, impl=impl,
                                        **knobs)
            close(logits, ref[i + 1], LOGIT_TOL)
        close(st["k_pages"], jst["k_pages"], LOGIT_TOL)


@pytest.mark.parametrize("name,chunk", [("W", 8), ("W", 13), ("AW", 13),
                                        ("swa", 8)])
def test_model_prefill_chunk_matches_reference(name, chunk):
    """Every chunk call's logits and the final pools: 'W' layers attend
    over the intact ring and the fresh chunk, then write; 'A' layers write
    and run K3's plain version."""
    jcfg, jm, jp, tm, tp = _models(name)
    B = 2
    lens = np.array([41, 27], np.int32)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                             (B, int(lens.max())))
    pool, tables = _state(jcfg, B, _width(jcfg, int(lens.max())), 4)
    tables = tables[:, 0]
    jst = {"pos": jnp.zeros((B,), jnp.int32), "k_pages": jnp.asarray(pool),
           "v_pages": jnp.asarray(pool), "tables": jnp.asarray(tables)}
    tst = {impl: {"k_pages": t(pool), "v_pages": t(pool),
                  "tables": t(tables)} for impl in ("kernel", "ref")}
    start = np.zeros_like(lens)
    while (start < lens).any():
        ql = np.maximum(np.minimum(chunk, lens - start), 0).astype(np.int32)
        batch = np.zeros((B, int(ql.max())), np.int32)
        for b in range(B):
            batch[b, :ql[b]] = toks[b, start[b]:start[b] + ql[b]]
        ref, jst = jm.prefill_chunk(jp, jnp.asarray(batch), jst,
                                    q_start=jnp.asarray(start),
                                    q_lens=jnp.asarray(ql), impl="jnp")
        live = ql > 0
        for impl, st in tst.items():
            lg, _ = tm.prefill_chunk(tp, t(batch, torch.int64), st,
                                     t(start), t(ql), impl=impl)
            close(lg[t(live)], np.asarray(ref)[live], LOGIT_TOL)
        start = start + ql
    for st in tst.values():
        close(st["k_pages"], jst["k_pages"], LOGIT_TOL)
        close(st["v_pages"], jst["v_pages"], LOGIT_TOL)


def test_params_from_numpy_converts_w_groups():
    """'W' groups carry the 'A' parameters; layers come out in the
    pattern's order."""
    jcfg, _, jp, tm, tp = _models("AW", seed=3)
    assert jcfg.pattern() == "AW" and set(jp["groups"]) == {"0A", "1W"}
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    for li, key in enumerate(("0A", "1W")):
        np.testing.assert_array_equal(
            tp["layers"][li]["attn"]["wq"].numpy(),
            np.asarray(jp["groups"][key]["attn"]["wq"][0]))


# -- the engine ---------------------------------------------------------------
PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6] * 4, [11, 12, 13], [7] * 25,
           [4, 5, 6, 7, 8]]


@pytest.fixture(scope="module", params=["W", "AW", "swa"])
def weights(request):
    jcfg, _, jp, _, tp = _models(request.param, seed=7)
    return request.param, jcfg, jp, tp


def _pair(weights, max_new, **knobs):
    """The same greedy requests through the JAX reference engine and the
    port's engine with shared weights: equal tokens, steps, scheduler
    counters and memory report."""
    name, jcfg, jp, tp = weights
    jeng = JEngine(jcfg, jp, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    eng = Engine(_configs(name)[1], tp, device="cpu", pages_per_block=1,
                 num_splits=2, **knobs)
    out = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        reqs = [R(prompt=list(p), max_new_tokens=max_new) for p in PROMPTS]
        e.generate(reqs, max_steps=1000)
        out.append(reqs)
    assert all(r.done for r in out[1])
    assert [r.output for r in out[1]] == [r.output for r in out[0]]
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    assert (eng.pages_per_seq, eng.num_pages) == (jeng.pages_per_seq,
                                                 jeng.num_pages)
    assert eng.memory_report() == jeng.memory_report()
    return jeng, eng


@pytest.mark.parametrize("chunk", [None, 8, 13])
def test_engine_tokens_equal_reference(weights, chunk):
    """Greedy decode past the window (the longest request ends at 32 + 20
    tokens), monolithic and chunked; the pool holds every request's full
    length, since the host reserves a page per token."""
    _, jcfg, _, _ = weights
    _, eng = _pair(weights, 20, max_slots=4, max_seq_len=64,
                   pool_tokens=4 * 64, prefill_chunk=chunk)
    assert max(len(p) for p in PROMPTS) + 20 > jcfg.window + jcfg.page_size


def test_engine_memory_report_mid_run_equals_reference(weights):
    """pages_per_seq and num_pages with the default pool, and the memory
    report while requests are live."""
    name, jcfg, jp, tp = weights
    knobs = dict(max_slots=2, max_seq_len=64)
    jeng = JEngine(jcfg, jp, impl="ref", **knobs)
    eng = Engine(_configs(name)[1], tp, device="cpu", **knobs)
    for e, R in ((jeng, JRequest), (eng, Request)):
        e.add_request(R(prompt=[1] * 12, max_new_tokens=4))
        e.step()
    assert (eng.pages_per_seq, eng.num_pages) == (jeng.pages_per_seq,
                                                 jeng.num_pages)
    assert eng.memory_report() == jeng.memory_report()


def test_ring_tables_truncate_by_design():
    """Pure-'W' models: the host row may outgrow the ring-wide device
    table (here 4 pages > ring 3), and row[:ring] is the table.  A mixed
    pattern gets a full-width table."""
    _, tcfg = _configs("W")
    eng = Engine(tcfg, device="cpu", max_slots=2, max_seq_len=64)
    assert eng.pages_per_seq == 3  # ceil(16 / 8) + 1
    req = Request(prompt=[1] * 30, max_new_tokens=4)
    eng.add_request(req)
    eng.step()
    assert len(eng.mgr.tables[req.rid]) > eng.pages_per_seq
    row = eng._tables_np()[req.slot, 0]
    assert (row >= 0).all()
    assert list(row) == eng.mgr.tables[req.rid][:3]
    mixed = Engine(_configs("AW")[1], device="cpu", max_slots=2,
                   max_seq_len=64)
    assert mixed.pages_per_seq == 8


@pytest.mark.parametrize("name", ["W", "AW"])
def test_prefix_cache_with_a_window_raises(name):
    jcfg, tcfg = _configs(name)
    with pytest.raises(JEngineConfigError):
        JEngine(jcfg, impl="ref", prefix_cache=True)
    with pytest.raises(EngineConfigError):
        Engine(tcfg, device="cpu", prefix_cache=True)
