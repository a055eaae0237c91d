"""PyTorch port: the GQA groups and head dims of the Nemotron-4 family
against the JAX package, from numpy inputs with a fixed seed.

- (a) K1's, K3's and K4's plain versions against the Pallas K1 and K3
  (interpret mode, split by split) and the Pallas ``_flex_kernel`` at G in
  {3, 6, 12, 16} query heads per kv head and D in {64, 192}, at
  ``ATTN_TOL``.  K3 runs at the engine's Q-block sizing
  (``choose_prefill_params``: 21 tokens, R = 126 rows, at G 6; 10 and 120
  at G 12), which equals the reference's.
- (b) Two Nemotron-shaped smoke configs, on the JAX weights through
  ``params_from_numpy``: G 6 (12 heads over 2, D 64) and G 12 at D 192
  (12 heads over 1) — prefill, ``prefill_chunk`` and ``decode_step``
  logits against the JAX model at ``LOGIT_TOL``.
- (c) The G 6 config through the engine: greedy tokens, step counts and
  ``memory_report`` against the JAX ``Engine(impl="ref")``, monolithic and
  with ``prefill_chunk`` + ``prefix_cache``.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import get_smoke
from repro.core import flex as jflex
from repro.kernels.flex_attention.ops import flex_attention as jflex_attention
from repro.kernels.paged_attention import ops as jops
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core import flex as tflex
from repro_torch.kernels.flex_attention.ops import (
    flex_attention as tflex_attention)
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import paged_attention as tpa
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import (ATTN_TOL, LOGIT_TOL, close, paged_case,  # noqa: F401
                            pallas_interpret, t)

GROUPS = [3, 6, 12, 16]
HEAD_DIMS = [64, 192]


# -- (a) the kernels' plain versions against the Pallas kernels ---------------
@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
def test_decode_partials_match_pallas(pallas_interpret, G, D):
    rng = np.random.default_rng(100 * G + D)
    q, kp, vp, tables, lens = paged_case(rng, 2, 2, G, D, 8, 5, [37, 9])
    kw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=2)
    port = tpa.paged_attention_partials(t(q), t(kp), t(vp), t(tables),
                                        t(lens), **kw)
    pallas = jpa.paged_attention_partials(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), **kw)
    S = pallas[0].shape[2]
    assert port[0].shape == (2, 2, S, G) and port[2].shape[-1] == D
    for s in range(S):  # split by split
        for a, b in zip(port, pallas):
            close(a[:, :, s], b[:, :, s], ATTN_TOL)


def _prefill_case(rng, G, D, kv_lens, q_start, Hkv=2, page=8, max_pages=6):
    """numpy (q (B, C, Hkv·G, D), pools, tables, kv_lens, q_start)."""
    B = len(kv_lens)
    kv_lens = np.asarray(kv_lens, np.int32)
    q_start = np.asarray(q_start, np.int32)
    C = int((kv_lens - q_start).max())
    _, kp, vp, tables, _ = paged_case(rng, B, Hkv, 1, D, page, max_pages,
                                      kv_lens)
    q = rng.standard_normal((B, C, Hkv * G, D)).astype(np.float32)
    return q, kp, vp, tables, kv_lens, q_start


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
def test_prefill_partials_match_pallas_at_the_engine_q_block(
        pallas_interpret, G, D):
    rng = np.random.default_rng(200 * G + D)
    arrs = _prefill_case(rng, G, D, kv_lens=[40, 22], q_start=[13, 0])
    C = arrs[0].shape[1]
    ppb, ns, qb = tops.choose_prefill_params(6, 8, D, C, G, num_splits=2)
    jppb, jns, _, jqb = jops.choose_prefill_params(6, 8, D, C, G,
                                                   num_splits=2,
                                                   backend="tpu")
    assert (ppb, ns, qb) == (jppb, jns, jqb)
    assert qb == min(128 // G, C)  # R = 126 rows at G 6 (C = 27 here)
    kw = dict(scale=D ** -0.5, pages_per_block=ppb, num_splits=ns,
              q_block=qb)
    port = tpa.paged_prefill_partials(*map(t, arrs), **kw)
    pallas = jpa.paged_prefill_partials(*map(jnp.asarray, arrs),
                                        interpret=True, **kw)
    assert port[0].shape == pallas[0].shape
    assert port[0].shape[-1] == qb * G
    for s in range(pallas[0].shape[3]):  # split by split
        for a, b in zip(port, pallas):
            close(a[:, :, :, s], b[:, :, :, s], ATTN_TOL)


@pytest.mark.parametrize("D", HEAD_DIMS)
@pytest.mark.parametrize("G", GROUPS)
def test_flex_causal_padding_matches_pallas(G, D):
    rng = np.random.default_rng(300 * G + D)
    B, Hkv, Q = 2, 1, 40
    q = rng.standard_normal((B, Hkv * G, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    lens = np.array([Q, 23], np.int32)
    jm = jflex.and_masks(jflex.causal_mask,
                         jflex.padding_mask(jnp.asarray(lens)))
    tm = tflex.and_masks(tflex.causal_mask, tflex.padding_mask(t(lens)))
    ref = jflex_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask_mod=jm, impl="pallas", q_block=16,
                          kv_block=16)
    port = tflex_attention(t(q), t(k), t(v), mask_mod=tm, q_block=16,
                           kv_block=16)
    close(port, ref, ATTN_TOL)


# -- (b) Nemotron-shaped models: logits against the JAX model -----------------
NEMOTRON = {"G6 D64": dict(n_heads=12, n_kv_heads=2, head_dim=64),
            "G12 D192": dict(n_heads=12, n_kv_heads=1, head_dim=192)}


def _configs(name):
    """(JAX config, port config) of a Nemotron-4-15b smoke variant."""
    return (get_smoke("nemotron-4-15b").replace(**NEMOTRON[name]),
            tget_smoke("nemotron-4-15b").replace(**NEMOTRON[name]))


def _models(name, seed=0):
    jcfg, tcfg = _configs(name)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jm, jp, build_model(tcfg), tp


@pytest.mark.parametrize("name", list(NEMOTRON))
def test_model_prefill_and_decode_logits_match_reference(name):
    cfg, jm, jp, tm, tp = _models(name)
    assert cfg.n_heads // cfg.n_kv_heads in (6, 12)
    rng = np.random.default_rng(1)
    B, P = 2, cfg.page_size
    lens = np.array([21, 13], np.int32)
    S, pps = int(lens.max()), 5
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tables = rng.permutation(B * pps + 1)[:B * pps].reshape(
        B, 1, pps).astype(np.int32)
    pool = (cfg.n_layers, B * pps + 1, P, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.zeros(pool), "v_pages": jnp.zeros(pool)}
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens), impl="ref")
    ref, steps = [np.asarray(jl)], []
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        steps.append(nxt)
        jl, jst = jm.decode_step(jp, jnp.asarray(nxt), jst, impl="ref")
        ref.append(np.asarray(jl))
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for impl, knobs in (("kernel", dict(pages_per_block=2, num_splits=2)),
                        ("ref", {})):
        st = {"pos": t(lens), "tables": t(tables),
              "k_pages": torch.zeros(pool), "v_pages": torch.zeros(pool)}
        logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                                impl=impl)
        close(logits, ref[0], LOGIT_TOL)
        for i, tok in enumerate(steps):  # teacher-forced: same inputs
            logits, st = tm.decode_step(tp, t(tok).long(), st, impl=impl,
                                        **knobs)
            close(logits, ref[i + 1], LOGIT_TOL)


@pytest.mark.parametrize("name", list(NEMOTRON))
def test_model_prefill_chunk_matches_reference(name):
    cfg, jm, jp, tm, tp = _models(name, seed=2)
    B, S, chunk = 2, 21, 8
    lens = np.array([S, S - 6], np.int32)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    pps = -(-S // cfg.page_size) + 1
    pool = np.zeros((cfg.n_layers, B * pps + 1, cfg.page_size,
                     cfg.n_kv_heads, cfg.resolved_head_dim), np.float32)
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
    jst = {"pos": jnp.zeros((B,), jnp.int32), "k_pages": jnp.asarray(pool),
           "v_pages": jnp.asarray(pool), "tables": jnp.asarray(tables)}
    st = {"k_pages": t(pool), "v_pages": t(pool), "tables": t(tables)}
    start = np.zeros_like(lens)
    while (start < lens).any():
        ql = np.maximum(np.minimum(chunk, lens - start), 0).astype(np.int32)
        batch = np.zeros((B, int(ql.max())), np.int32)
        for b in range(B):
            batch[b, :ql[b]] = toks[b, start[b]:start[b] + ql[b]]
        ref, jst = jm.prefill_chunk(jp, jnp.asarray(batch), jst,
                                    q_start=jnp.asarray(start),
                                    q_lens=jnp.asarray(ql), impl="jnp")
        lg, st = tm.prefill_chunk(tp, t(batch, torch.int64), st, t(start),
                                  t(ql))
        live = ql > 0
        close(lg[t(live)], np.asarray(ref)[live], LOGIT_TOL)
        start = start + ql
    close(st["k_pages"], jst["k_pages"], LOGIT_TOL)


# -- (c) the G 6 engine: greedy tokens and memory against the JAX engine ------
HEAD = [9] * 24  # a shared head: 3 pages of 8 tokens
WAVES = [[(HEAD + [1, 2, 3], 5), ([5, 6, 7] * 5, 6)],
         [(HEAD + [5] * 9, 5), (HEAD + [4, 5, 6, 7, 8], 4)]]


@pytest.fixture(scope="module")
def g6_weights():
    jcfg, _, jp, _, tp = _models("G6 D64", seed=7)
    return jcfg, jp, tp


@pytest.mark.parametrize("knobs", [{}, dict(prefill_chunk=8,
                                            prefix_cache=True)],
                         ids=["monolithic", "chunked+prefix_cache"])
def test_engine_tokens_and_memory_equal_reference(g6_weights, knobs):
    jcfg, jp, tp = g6_weights
    knobs = dict(max_slots=2, max_seq_len=64, **knobs)
    jeng = JEngine(jcfg, jp, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    eng = Engine(_configs("G6 D64")[1], tp, device="cpu", pages_per_block=1,
                 num_splits=2, **knobs)
    for wave in WAVES:
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            reqs = [R(prompt=list(p), max_new_tokens=n) for p, n in wave]
            e.generate(reqs, max_steps=500)
            out.append(reqs)
        assert all(r.done for r in out[1])
        assert [r.output for r in out[1]] == [r.output for r in out[0]]
        assert eng.steps == jeng.steps
        assert eng.memory_report() == jeng.memory_report()
    if knobs.get("prefix_cache"):
        assert eng.prefix_cache.hit_tokens >= 2 * len(HEAD)
