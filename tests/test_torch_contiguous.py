"""PyTorch port: the contiguous baseline (``Engine(paged=False)``) against
the JAX package.

- ``decode_attention_contiguous`` over window, softcap and GQA, with a
  dead row (lens 0); ``gather_layer`` over GQA and lengths off the page;
  the contiguous writes by position and ``init_contiguous``;
- the model's ``prefill`` and ``decode_step`` on the contiguous state
  against the JAX model on the paged state (patterns 'A', 'W' past the
  ring, 'RW');
- the engine: pattern 'A' greedy tokens and every ``memory_report`` key
  (``used_pages`` -1) against the JAX ``Engine(paged=False,
  impl="ref")``; patterns 'W' past the ring and 'RW' against the *paged*
  JAX engine, because the JAX baseline is wrong there (its decode skips
  'R' layers, and its prefill reads a wrapped ring back in the wrong
  order: ``test_jax_baseline_breaks_w_layers_past_the_ring`` measures
  the second); the refusals of ``kv_dtype="int8"``, ``prefill_chunk``
  and ``prefix_cache``.

Inputs are made with numpy from a seed and handed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import attention as jattn
from repro.core import cache as jcache
from repro.errors import EngineConfigError as JEngineConfigError
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core import attention as tattn
from repro_torch.core import cache as tcache
from repro_torch.errors import EngineConfigError
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request, Status

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, paged_case, t

# smoke variants: llama2-7b 'A' and 'W' (window 16: a ring of 3 pages of
# 8), recurrentgemma-9b 'RW' with the same window
VARIANTS = {"A": ("llama2-7b", {}),
            "W": ("llama2-7b", dict(layer_pattern="W", window=16)),
            "RW": ("recurrentgemma-9b", dict(window=16))}


def _configs(name):
    base, kw = VARIANTS[name]
    return get_smoke(base).replace(**kw), tget_smoke(base).replace(**kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- the core functions -------------------------------------------------------

@pytest.mark.parametrize("window,softcap,G", [(0, 0.0, 1), (0, 0.0, 4),
                                              (5, 0.0, 2), (0, 30.0, 1),
                                              (7, 20.0, 4)])
def test_decode_attention_contiguous_matches_reference(window, softcap, G):
    rng = np.random.default_rng(window * 10 + G)
    B, S, Hkv, D = 4, 40, 2, 16
    q = rng.standard_normal((B, Hkv * G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    lens = np.array([1, 17, 40, 0], np.int32)  # the last row has no key
    ref = jattn.decode_attention_contiguous(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        window=window, softcap=softcap)
    # the port's buffers are head-major: (B, Hkv, max_len, D)
    got = tattn.decode_attention_contiguous(
        t(q), t(k).transpose(1, 2), t(v).transpose(1, 2), t(lens),
        window=window, softcap=softcap)
    assert got.shape == (B, Hkv * G, D)
    close(got, ref, ATTN_TOL)


@pytest.mark.parametrize("Hkv,max_len", [(1, 37), (2, 64), (4, 5)])
def test_gather_layer_matches_reference(Hkv, max_len):
    """Scattered pages, NULL pages past each row's length (zeros)."""
    rng = np.random.default_rng(Hkv)
    _, kp, vp, tables, _ = paged_case(rng, 3, Hkv, 1, 8, 8, 8,
                                      [37, 9, 0])
    jk, jv = jcache.gather_layer(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(tables), max_len)
    k, v = tcache.gather_layer(t(kp), t(vp), t(tables), max_len)
    assert k.shape == (3, max_len, Hkv, 8)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_contiguous_writes_store_by_position():
    """``init_contiguous`` as the JAX one but head-major (and with no
    ``lens``: rows' lengths are the engine's ``pos``); the prefill write
    stores rows at positions 0..S-1 of their slots; the decode write
    stores one token per row at its position and drops a position past
    the buffer."""
    jbuf = jcache.init_contiguous(2, 3, 12, 2, 4)
    buf = tcache.init_contiguous(2, 3, 12, 2, 4, device="cpu")
    assert len(buf) == 2
    for a, b in zip(buf, (jbuf.k, jbuf.v)):
        assert tuple(a.shape) == (2, 3, 2, 12, 4) and b.shape == (2, 3, 12,
                                                                   2, 4)
        assert a.dtype == t(b).dtype and not a.any()
    rng = np.random.default_rng(0)
    k = rng.standard_normal((2, 7, 2, 4)).astype(np.float32)
    tcache.write_contiguous_prefill(buf.k[1], buf.v[1], t(np.array([2, 0])),
                                    t(k), t(-k))
    want = np.zeros((3, 2, 12, 4), np.float32)
    want[2, :, :7] = k[0].transpose(1, 0, 2)
    want[0, :, :7] = k[1].transpose(1, 0, 2)
    np.testing.assert_array_equal(buf.k[1].numpy(), want)
    np.testing.assert_array_equal(buf.v[1].numpy(), -want)
    new = rng.standard_normal((3, 2, 4)).astype(np.float32)
    pos = np.array([7, 12, 0], np.int32)  # row 1's position is past the end
    tcache.write_contiguous_decode(buf.k[1], buf.v[1], t(pos), t(new),
                                   t(new))
    ref = jnp.asarray(want).at[jnp.arange(3), :, jnp.asarray(pos)].set(new)
    np.testing.assert_array_equal(buf.k[1].numpy(), np.asarray(ref))


# -- the model ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(VARIANTS))
def test_model_contiguous_logits_match_paged_reference(name):
    """Rows of one length (40 > the ring's 24 tokens under 'W'), prefilled
    into buffer rows 2 and 0 of 3, then 8 teacher-forced decode steps on
    the whole buffer, against the JAX model on paged pools."""
    jcfg, tcfg = _configs(name)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(3))
    tm, tp = build_model(tcfg), params_from_numpy(_np(jp), device="cpu")
    rng = np.random.default_rng(1)
    B, S, steps, max_len = 2, 40, 8, 64
    lens = np.full((B,), S, np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pps = 8
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = np.zeros((tm.n_attn_layers, B * pps + 1, jcfg.page_size,
                     jcfg.n_kv_heads, jcfg.resolved_head_dim), np.float32)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    rec = tm.init_rec_state(B)
    if rec is not None:
        jst["rec"] = jax.tree_util.tree_map(jnp.asarray, _np(rec))
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens), impl="ref")
    ref, feed = [np.asarray(jl)], []
    for _ in range(steps):
        feed.append(rng.integers(0, jcfg.vocab_size, B).astype(np.int32))
        jl, jst = jm.decode_step(jp, jnp.asarray(feed[-1]), jst, impl="ref")
        ref.append(np.asarray(jl))

    buf = tcache.init_contiguous(tm.n_attn_layers, 3, max_len,
                                 tcfg.n_kv_heads, tcfg.resolved_head_dim,
                                 device="cpu")
    slots = torch.tensor([2, 0])
    st = {"pos": t(lens), "k_buf": buf.k, "v_buf": buf.v, "slots": slots}
    logits, new = tm.prefill(tp, t(tokens).long(), st, lens=t(lens))
    close(logits, ref[0], LOGIT_TOL)
    # the whole buffer decodes; row 1 is dead (its output is not read)
    full = {"pos": torch.zeros(3, dtype=torch.int32), "k_buf": buf.k,
            "v_buf": buf.v}
    full["pos"][slots] = t(lens)
    if "rec" in new:
        full["rec"] = tm.init_rec_state(3)
        for k, v in new["rec"]["R"].items():
            full["rec"]["R"][k][:, slots] = v
    for i, tok in enumerate(feed):
        toks = torch.zeros(3, dtype=torch.long)
        toks[slots] = t(tok).long()
        logits, full = tm.decode_step(tp, toks, full)
        close(logits[slots], ref[i + 1], LOGIT_TOL)
    assert full["pos"].tolist() == [S + steps, steps, S + steps]


# -- the engine ---------------------------------------------------------------

def _engines(name, knobs, paged_ref, key=7):
    jcfg, tcfg = _configs(name)
    jeng = JEngine(jcfg, impl="ref", rng=jax.random.PRNGKey(key),
                   paged=paged_ref, **knobs)
    eng = Engine(tcfg, params_from_numpy(_np(jeng.params), device="cpu"),
                 device="cpu", paged=False, **knobs)
    return jeng, eng


def _serve(e, R, prompts, max_new):
    reqs = [R(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    e.generate(reqs, max_steps=500)
    return reqs


def test_engine_pattern_a_matches_reference_baseline():
    """Greedy tokens, steps and every memory_report key against the JAX
    baseline, mid-run (live requests) and at the end; the host still
    admits by pages, so 6 requests on 3 slots and a 96-token pool queue."""
    knobs = dict(max_slots=3, max_seq_len=48, pool_tokens=96)
    jeng, eng = _engines("A", knobs, paged_ref=False)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, int(n)).tolist()
               for n in rng.integers(4, 30, 6)]
    out = []
    for e, R in ((jeng, JRequest), (eng, Request)):
        reqs = [R(prompt=list(p), max_new_tokens=10) for p in prompts]
        for r in reqs:
            e.add_request(r)
        e.step()
        e.step()
        out.append((reqs, e.memory_report()))
        for _ in range(500):
            if all(r.done for r in reqs):
                break
            e.step()
    (jreqs, jmid), (reqs, mid) = out
    assert mid["used_pages"] == -1.0 and mid["theoretical_min_bytes"] > 0
    assert mid == jmid
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(r.status is Status.FINISHED for r in reqs)
    assert eng.steps == jeng.steps
    assert eng.memory_report() == jeng.memory_report()
    assert eng.mgr.used_pages == 0 and "k_pages" not in eng.state
    assert tuple(eng.state["k_buf"].shape) == (2, 3, 4, 48, 64)


@pytest.mark.parametrize("name", ["W", "RW"])
def test_engine_w_and_rw_match_the_paged_reference(name):
    """Prompts of 40 tokens (past the 24-token ring), 12 new tokens each,
    two waves of equal-length prompts: the tokens equal the paged JAX
    engine's (the JAX baseline's differ, see below).  Equal lengths keep
    the JAX engine's padded-wave recurrent-state fault out of the way."""
    knobs = dict(max_slots=2, max_seq_len=64, pool_tokens=4 * 64)
    jeng, eng = _engines(name, knobs, paged_ref=True)
    rng = np.random.default_rng(4)
    prompts = rng.integers(0, 512, (4, 40)).tolist()
    jreqs = _serve(jeng, JRequest, prompts, 12)
    reqs = _serve(eng, Request, prompts, 12)
    assert all(r.status is Status.FINISHED for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in jreqs]


def test_jax_baseline_breaks_w_layers_past_the_ring():
    """The JAX package's fault this port does not copy (the JAX package is
    not edited): its ``_prefill_contiguous`` prefills into a temporary
    pool whose 'W' layers wrap their writes around the ring, then
    ``gather_layer`` reads the pages back as if positions ran in order.
    Smoke llama2-7b, pattern 'W', window 16 (a ring of 24 slots), f32,
    ``PRNGKey(7)``, 2 slots, max_seq_len 64, a 128-token pool, two random
    prompts, 8 greedy tokens: at 12 tokens the JAX baseline equals the
    paged JAX engine, at 40 tokens both rows diverge; the port's baseline
    equals the paged JAX engine at both lengths."""
    knobs = dict(max_slots=2, max_seq_len=64, pool_tokens=128)
    jcfg, tcfg = _configs("W")
    rng = np.random.default_rng(7)
    outs = {}
    for n in (12, 40):
        prompts = rng.integers(0, jcfg.vocab_size, (2, n)).tolist()
        for paged in (True, False):
            e = JEngine(jcfg, impl="ref", rng=jax.random.PRNGKey(7),
                        paged=paged, **knobs)
            outs[n, paged] = [r.output for r in _serve(e, JRequest, prompts,
                                                       8)]
        eng = Engine(tcfg, params_from_numpy(_np(e.params), device="cpu"),
                     device="cpu", paged=False, **knobs)
        outs[n, "port"] = [r.output for r in _serve(eng, Request, prompts, 8)]
    print(f"JAX baseline vs paged at 40 tokens: {outs[40, False]} vs "
          f"{outs[40, True]}")
    assert outs[12, False] == outs[12, True] == outs[12, "port"]
    assert all(a != b for a, b in zip(outs[40, False], outs[40, True]))
    assert outs[40, "port"] == outs[40, True]


def test_baseline_refusals():
    """The baseline refuses chunked prefill and the prefix cache (as the
    JAX engine does) and an int8 KV cache (the JAX baseline would mix
    int8 and unquantised K/V)."""
    jcfg, tcfg = _configs("A")
    for kw in (dict(prefill_chunk=8), dict(prefix_cache=True)):
        with pytest.raises(JEngineConfigError):
            JEngine(jcfg, impl="ref", paged=False, **kw)
        with pytest.raises(EngineConfigError):
            Engine(tcfg, device="cpu", paged=False, **kw)
    with pytest.raises(EngineConfigError, match="int8"):
        Engine(tcfg.replace(kv_dtype="int8"), device="cpu", paged=False)
    # the config's own switch selects the baseline too
    eng = Engine(tcfg.replace(paged_attention=False), device="cpu",
                 max_slots=1, max_seq_len=16)
    assert not eng.paged and "k_buf" in eng.state
