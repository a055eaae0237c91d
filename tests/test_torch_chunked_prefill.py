"""PyTorch port: chunked paged prefill against the JAX package — the chunk
scatter ``write_layer_prefill_at`` (dense and ring), the model's
``prefill_chunk`` logits (``LOGIT_TOL``) and pools, chunked == monolithic
inside the port, and the engine's greedy tokens with ``prefill_chunk`` of
one page, two pages and an odd size, under preemption and through a
prefill stall, equal to the JAX ``Engine(impl="ref")``'s step for step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import cache as jcache
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core import cache as tcache
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request

from _torch_helpers import LOGIT_TOL, close, t


@pytest.mark.parametrize("window", [0, 20])
def test_write_layer_prefill_at_equals_reference(window):
    rng = np.random.default_rng(window)
    num_pages, page, H, D, B, C = 24, 4, 2, 8, 3, 9
    kp = rng.standard_normal((num_pages, page, H, D)).astype(np.float32)
    vp = rng.standard_normal((num_pages, page, H, D)).astype(np.float32)
    width = (-(-window // page) + 1) if window else 6
    tables = rng.permutation(num_pages)[:B * width].reshape(
        B, width).astype(np.int32)
    tables[2, width // 2:] = -1  # a short row
    k = rng.standard_normal((B, C, H, D)).astype(np.float32)
    v = rng.standard_normal((B, C, H, D)).astype(np.float32)
    start = np.array([0, 5, 3], np.int32) + (17 if window else 0)
    q_lens = np.array([9, 4, 0], np.int32)  # a dead row writes nothing
    ref_k, ref_v = jcache.write_layer_prefill_at(
        *map(jnp.asarray, (kp, vp, tables, k, v, start, q_lens)),
        window=window)
    pk, pv = t(kp), t(vp)
    tcache.write_layer_prefill_at(pk, pv, *map(t, (tables, k, v, start,
                                                   q_lens)), window=window)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(ref_k))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(ref_v))


def _models():
    cfg = get_smoke("llama2-7b")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return cfg, jm, jp, build_model(tget_smoke("llama2-7b")), tp


def _pools(cfg, B, pps):
    shape = (cfg.n_layers, B * pps + 1, cfg.page_size, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    return np.zeros(shape, np.float32), tables


def _chunks(lens, chunk):
    """The (q_start, q_lens) installments that cover ``lens``."""
    start = np.zeros_like(lens)
    while (start < lens).any():
        ql = np.maximum(np.minimum(chunk, lens - start), 0).astype(np.int32)
        yield start.copy(), ql
        start = start + ql


@pytest.mark.parametrize("chunk", [8, 13])
def test_model_prefill_chunk_equals_reference(chunk):
    """Every chunk call's logits and the final pools equal the JAX
    model's, on the port's kernel path (K3's plain version) and its
    oracle path."""
    cfg, jm, jp, tm, tp = _models()
    B, S = 2, 21
    lens = np.array([S, S - 6], np.int32)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S))
    pool, tables = _pools(cfg, B, -(-S // cfg.page_size) + 1)
    jst = {"pos": jnp.zeros((B,), jnp.int32), "k_pages": jnp.asarray(pool),
           "v_pages": jnp.asarray(pool), "tables": jnp.asarray(tables)}
    tst = {impl: {"k_pages": t(pool), "v_pages": t(pool),
                  "tables": t(tables)} for impl in ("kernel", "ref")}
    for start, ql in _chunks(lens, chunk):
        C = int(ql.max())
        batch = np.zeros((B, C), np.int32)
        for b in range(B):
            batch[b, :ql[b]] = toks[b, start[b]:start[b] + ql[b]]
        ref, jst = jm.prefill_chunk(jp, jnp.asarray(batch), jst,
                                    q_start=jnp.asarray(start),
                                    q_lens=jnp.asarray(ql), impl="jnp")
        live = ql > 0
        for impl, st in tst.items():
            lg, new = tm.prefill_chunk(tp, t(batch, torch.int64), st,
                                       t(start), t(ql), impl=impl)
            close(lg[t(live)], np.asarray(ref)[live], LOGIT_TOL)
            np.testing.assert_array_equal(new["pos"].numpy(),
                                          np.asarray(jst["pos"]))
    for st in tst.values():
        close(st["k_pages"], jst["k_pages"], LOGIT_TOL)
        close(st["v_pages"], jst["v_pages"], LOGIT_TOL)


def test_port_chunked_equals_port_monolithic():
    """Chunks of one page, two pages and an odd size reproduce the
    port's own monolithic prefill: logits and pools."""
    cfg, _, _, tm, tp = _models()
    B, S = 2, 21
    lens = np.array([S, S - 6], np.int32)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    pool, tables = _pools(cfg, B, -(-S // cfg.page_size) + 1)
    mono = {"k_pages": t(pool), "v_pages": t(pool), "tables": t(tables)}
    ref, _ = tm.prefill(tp, t(toks, torch.int64), mono, lens=t(lens))
    for chunk in (cfg.page_size, 2 * cfg.page_size, cfg.page_size + 3):
        st = {"k_pages": t(pool), "v_pages": t(pool), "tables": t(tables)}
        last = torch.zeros_like(ref)
        for start, ql in _chunks(lens, chunk):
            batch = np.zeros((B, int(ql.max())), np.int64)
            for b in range(B):
                batch[b, :ql[b]] = toks[b, start[b]:start[b] + ql[b]]
            lg, _ = tm.prefill_chunk(tp, t(batch), st, t(start), t(ql))
            ends = t((start + ql == lens) & (ql > 0))
            last[ends] = lg[ends]
        close(last, ref, LOGIT_TOL)
        close(st["k_pages"], mono["k_pages"], LOGIT_TOL)


PROMPTS = [[1, 2, 3, 4, 5, 6, 7] * 2, [11, 12, 13], [9] * 25, [4, 5]]


@pytest.fixture(scope="module")
def jparams():
    cfg = get_smoke("llama2-7b")
    return jbuild(cfg).init_params(jax.random.PRNGKey(7))


def _pair(jparams, prompts, max_new, drive=None, **knobs):
    """Run the same requests (``max_new`` tokens each, or one count per
    prompt) through the JAX reference engine and the port's engine with
    shared weights; their tokens, steps and scheduler counters agree."""
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    cfg = get_smoke("llama2-7b")
    jeng = JEngine(cfg, jparams, impl="ref", rng=jax.random.PRNGKey(7),
                   **knobs)
    eng = Engine(tget_smoke("llama2-7b"), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"),
        device="cpu", **knobs)
    out = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        reqs = [R(prompt=list(p), max_new_tokens=n)
                for p, n in zip(prompts, news)]
        if drive is None:
            e.generate(reqs, max_steps=1000)
        else:
            drive(e, reqs)
        out.append(reqs)
    assert all(r.done for r in out[1])
    assert [r.output for r in out[1]] == [r.output for r in out[0]]
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    assert eng.scheduler.prefill_stalls == jeng.scheduler.prefill_stalls
    assert eng.mgr.used_pages == jeng.mgr.used_pages == 0
    return jeng, eng


@pytest.mark.parametrize("chunk", [8, 16, 13])  # page, 2 pages, odd
def test_engine_chunked_tokens_equal_reference(jparams, chunk):
    _pair(jparams, PROMPTS, 6, max_slots=4, max_seq_len=64,
          prefill_chunk=chunk)


def test_engine_chunked_preemption_equals_reference(jparams):
    """An oversubscribed pool (12 pages against ~17 needed) preempts;
    preempted requests re-prefill chunk by chunk to the same tokens."""
    jeng, _ = _pair(jparams, PROMPTS, 20, max_slots=4, max_seq_len=64,
                    pool_tokens=96, prefill_chunk=8)
    assert jeng.scheduler.preempted >= 1


def test_engine_prefill_stall_equals_reference(jparams):
    """A prefill whose next chunk finds the pool dry stalls, keeps its
    pages and resumes from them once the decoding request finishes."""
    def drive(e, reqs):
        short, long_req = reqs
        e.add_request(short)
        e.step()
        e.add_request(long_req)
        for _ in range(300):
            if short.done and long_req.done:
                break
            e.step()

    jeng, _ = _pair(jparams, [[2] * 33, [7] * 40], [7, 3], drive=drive,
                    max_slots=2, max_seq_len=64, pool_tokens=72,
                    prefill_chunk=8)
    assert jeng.scheduler.prefill_stalls >= 1
    assert jeng.scheduler.preempted == 0
