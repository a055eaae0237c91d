"""PyTorch port: K3 and the engine over int8 KV pools against the JAX
package, from numpy inputs with a fixed seed.

- (a) K3's plain version keeps the int8 K and V as the integers they are
  and folds ``kv_scale`` in after the products, as the tensor-core tiles
  do (``s = q·k·scale·kv_scale``, ``acc = p·v·kv_scale``).  With the
  tiles' own product arithmetic — f32 q: two TF32 products against the
  exact K and V (``tf32_terms``); bf16 q: P as two bf16 terms
  (``p_terms``) — and without it (the wrapper's plain version on CPU
  tensors), it is held against the Pallas ``_prefill_kernel`` (interpret
  mode, split by split) at 2e-5 for f32 q and 2e-2 for bf16 q, on pages
  of 7, 8, 12, 64 and 96 tokens, G 1 and 6, D 64 and 192.  Both bounds
  are relative: ``|a - b| <= tol * (1 + |b|)`` for m and l, and for acc
  ``tol * (1 + Σ p·|v|·kv_scale)``, the magnitude its sum is taken over.
  acc is un-normalised: over ~150 keys of int8 V up to 127 · 0.05 it
  reaches hundreds while single elements cancel to near 0, and the f32
  rounding of such sums, the Pallas kernel's own included, is then of
  the order of 2e-5 of the element, so an element's own magnitude
  cannot scale its bound.
- (b) The folded arithmetic is exact where it should be: two TF32 terms
  equal three on int8 values (their low part is 0), and a page's tokens
  take the same partials whatever the page size.
- (c) The port's chunked model step over int8 pools against the JAX
  model's, and ``Engine(kv_dtype="int8", prefill_chunk, prefix_cache)``
  at smoke size against the JAX ``Engine(impl="ref")`` on the same
  converted weights: equal greedy tokens, ``memory_report`` and hit
  tokens, on pages of 8 and of 7 tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.configs import get_smoke
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.kernels.paged_attention import paged_attention as tpa
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import (ATTN_TOL, LOGIT_TOL, close, paged_case,  # noqa: F401
                            pallas_interpret, t)

BF16_TOL = 2e-2  # the card's bf16 tolerance, relative: tol * (1 + |b|)
KV_SCALE = 0.05  # the configs' int8 step


def rel_close(got, want, tol, mag=None):
    """``|got - want| <= tol * (1 + mag)``, ``mag`` = ``|want|`` unless
    given."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.abs(want) if mag is None else np.asarray(mag, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= tol * (1 + mag)).all(), float((err / (1 + mag)).max())


def _case(rng, G, D, page, kv_lens, q_start, Hkv=2):
    """numpy (q (B, C, Hkv·G, D) f32, int8 pools, tables, kv_lens,
    q_start): every page of the live rows scattered."""
    kv_lens = np.asarray(kv_lens, np.int32)
    q_start = np.asarray(q_start, np.int32)
    max_pages = -(-int(kv_lens.max()) // page)
    _, kp, vp, tables, _ = paged_case(rng, len(kv_lens), Hkv, 1, D, page,
                                      max_pages, kv_lens, kv_dtype=np.int8)
    C = int((kv_lens - q_start).max())
    q = rng.standard_normal((len(kv_lens), C, Hkv * G, D)).astype(np.float32)
    return q, kp, vp, tables, kv_lens, q_start


# -- (a) the folded int8 arithmetic against the Pallas K3 --------------------
@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [64, 192])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("page", [7, 8, 12, 64, 96])
def test_int8_prefill_partials_match_pallas(pallas_interpret, page, G, D,
                                            q_dtype):
    rng = np.random.default_rng(1000 * page + 10 * G + D)
    q, kp, vp, tables, kv_lens, q_start = _case(
        rng, G, D, page, kv_lens=[150, 61], q_start=[131, 40])
    q_j = jnp.asarray(q, jnp.bfloat16 if q_dtype == "bfloat16" else
                      jnp.float32)
    q_t = t(np.asarray(q_j.astype(jnp.float32))).to(getattr(torch, q_dtype))
    arrs = (kp, vp, tables, kv_lens, q_start)
    kw = dict(scale=D ** -0.5, softcap=0.0, kv_scale=KV_SCALE,
              pages_per_block=2, num_splits=2, q_block=max(1, 16 // G))
    pallas = jpa.paged_prefill_partials(q_j, *map(jnp.asarray, arrs),
                                        interpret=True, **kw)
    tile = (dict(tf32_terms=3) if q_dtype == "float32" else
            dict(p_terms=2))
    ports = (tpa.paged_prefill_partials(q_t, *map(t, arrs), **kw),
             tpa._paged_prefill_partials_plain(q_t, *map(t, arrs), **kw,
                                               **tile))
    # acc's magnitude: the same sum over |v|
    mag = tpa._paged_prefill_partials_plain(q_t, t(kp), t(np.abs(vp)),
                                            *map(t, arrs[2:]), **kw)[2]
    tol = ATTN_TOL if q_dtype == "float32" else BF16_TOL
    for port in ports:
        assert port[0].shape == pallas[0].shape
        for s in range(pallas[0].shape[3]):  # split by split
            for i, (a, b) in enumerate(zip(port, pallas)):
                rel_close(a[:, :, :, s], b[:, :, :, s], tol,
                          mag[:, :, :, s] if i == 2 else None)


# -- (b) what the fold keeps exact -------------------------------------------
def test_two_tf32_terms_equal_three_on_int8_values():
    """K and V of int8 pools are exact in TF32: the split-TF32 tile's
    third product (hi(q)·lo(k)) is 0, so the plain version's two terms
    are its three, to the last bit of each product."""
    from repro_torch.kernels import tf32_product
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((16, 64)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-127, 128, (64, 24)).astype(
        np.float32))
    three = tf32_product(torch.matmul, a, b, 3)
    two = tf32_product(torch.matmul, a, b, 2)
    assert torch.allclose(two, three, rtol=0, atol=1e-5)
    assert float((two - a @ b).abs().max()) < 1e-4 * float(b.abs().max())
    with pytest.raises(ValueError):
        tf32_product(torch.matmul, a, b, 4)


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_int8_partials_do_not_depend_on_the_page(q_dtype):
    """The same tokens in pages of 7, 8 and 12 (odd pages on the tiles
    have gaps between their boxes; the plain version has none): equal
    combined outputs, within f32 rounding."""
    rng = np.random.default_rng(9)
    Hkv, G, D, L, C = 2, 2, 64, 84, 20
    k = rng.integers(-127, 128, (L, Hkv, D)).astype(np.int8)
    v = rng.integers(-127, 128, (L, Hkv, D)).astype(np.int8)
    q = torch.from_numpy(rng.standard_normal((1, C, Hkv * G, D)).astype(
        np.float32)).to(q_dtype)
    outs = []
    for page in (7, 8, 12):
        n = -(-L // page)
        pad = n * page - L
        kp = np.concatenate([k, np.zeros((pad, Hkv, D), np.int8)])
        vp = np.concatenate([v, np.zeros((pad, Hkv, D), np.int8)])
        perm = rng.permutation(n)
        pools = [np.zeros((n, page, Hkv, D), np.int8) for _ in range(2)]
        pools[0][perm] = kp.reshape(n, page, Hkv, D)
        pools[1][perm] = vp.reshape(n, page, Hkv, D)
        m, l, acc = tpa.paged_prefill_partials(
            q, t(pools[0]), t(pools[1]), t(perm[None].astype(np.int32)),
            torch.tensor([L], dtype=torch.int32),
            torch.tensor([L - C], dtype=torch.int32), scale=D ** -0.5,
            kv_scale=KV_SCALE, pages_per_block=2, num_splits=1, q_block=4)
        outs.append(tpa.combine_prefill_partials(m, l, acc, C, 4))
    for o in outs[1:]:
        close(o, outs[0], ATTN_TOL)


# -- (c) the model and the engine over int8 pools -----------------------------
def _int8_configs(page=8):
    knobs = dict(kv_dtype="int8", page_size=page)
    return (get_smoke("llama2-7b").replace(**knobs),
            tget_smoke("llama2-7b").replace(**knobs))


@pytest.fixture(scope="module")
def jparams():
    return jbuild(get_smoke("llama2-7b")).init_params(jax.random.PRNGKey(7))


def _port_params(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


def test_model_prefill_chunk_over_int8_pools_matches_reference(jparams):
    jcfg, tcfg = _int8_configs()
    jm, tm, tp = jbuild(jcfg), build_model(tcfg), _port_params(jparams)
    B, S, chunk = 2, 21, 8
    lens = np.array([S, S - 6], np.int32)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (B, S))
    pps = -(-S // jcfg.page_size) + 1
    pool = np.zeros((jcfg.n_layers, B * pps + 1, jcfg.page_size,
                     jcfg.n_kv_heads, jcfg.resolved_head_dim), np.int8)
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
        ref, jst = jm.prefill_chunk(jparams, jnp.asarray(batch), jst,
                                    q_start=jnp.asarray(start),
                                    q_lens=jnp.asarray(ql), impl="jnp")
        lg, st = tm.prefill_chunk(tp, t(batch, torch.int64), st, t(start),
                                  t(ql))
        live = ql > 0
        close(lg[t(live)], np.asarray(ref)[live], LOGIT_TOL)
        start = start + ql
    assert st["k_pages"].dtype == torch.int8
    np.testing.assert_array_equal(st["k_pages"].numpy(),
                                  np.asarray(jst["k_pages"]))


HEAD = [9] * 24  # a shared head: 3 pages of 8 tokens
WAVES = [[(HEAD + [1, 2, 3], 5), ([5, 6, 7] * 5, 6)],
         [(HEAD + [5] * 9, 5), (HEAD + [4, 5, 6, 7, 8], 4)]]


@pytest.mark.parametrize("page", [8, 7])
def test_int8_engine_tokens_and_memory_equal_reference(jparams, page):
    jcfg, tcfg = _int8_configs(page)
    knobs = dict(max_slots=2, max_seq_len=64, prefill_chunk=8,
                 prefix_cache=True)
    jeng = JEngine(jcfg, jparams, impl="ref", rng=jax.random.PRNGKey(11),
                   **knobs)
    eng = Engine(tcfg, _port_params(jparams), device="cpu",
                 pages_per_block=2, num_splits=2, **knobs)
    assert eng.state["k_pages"].dtype == torch.int8
    for wave in WAVES:
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            reqs = [R(prompt=list(p), max_new_tokens=n) for p, n in wave]
            e.generate(reqs, max_steps=500)
            out.append(reqs)
        assert all(r.done for r in out[1])
        assert [r.output for r in out[1]] == [r.output for r in out[0]]
        assert eng.memory_report() == jeng.memory_report()
    assert eng.prefix_cache.hit_tokens == jeng.prefix_cache.hit_tokens
    assert eng.prefix_cache.hit_tokens >= 2 * (len(HEAD) // page) * page
