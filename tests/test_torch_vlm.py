"""PyTorch port: cross-attention (``C``) layers and the ``vlm`` family
(llama-3.2-vision-11b) against the JAX package, at smoke size (8 image
tokens, d_vision 1280, pattern ``CA``).

The JAX model initialises every cross-attention ``gate`` to zero, and
``tanh(0) = 0`` hides any fault of the cross-attention path from a parity
test on fresh weights: every test here sets the gates to 0.8 in the JAX
params before either package uses them.

* ``cross_kv`` and ``cross_attn`` (prefill- and decode-shaped queries)
  within ``ATTN_TOL``;
* model logits within ``LOGIT_TOL``: ``prefill`` and decode, and
  ``prefill_chunk`` through its three cross modes (``full``: every row
  at its first chunk; ``partial``: some; ``reuse``: none);
* greedy engine tokens with per-request image embeddings, monolithic and
  chunked, and the contiguous baseline (``paged=False``) against the
  paged JAX engine;
* ``fork_request`` copies the parent's cross rows to the child;
* the refusals: a missing or mis-shaped extra (``InvalidRequest``) and
  the prefix cache (``EngineConfigError``);
* the JAX baseline's decode skips ``C`` layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.errors import EngineConfigError as JEngineConfigError
from repro.models import attention as jattn
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import EngineConfigError, InvalidRequest
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.serving import Engine, Request, Status

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, t

NAME = "llama-3.2-vision-11b"
VARIANTS = {"CA2": {}, "CA4": dict(n_layers=4),
            "CAAAA5": dict(n_layers=5, layer_pattern="CAAAA")}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(variant="CA2"):
    kw = VARIANTS[variant]
    return get_smoke(NAME).replace(**kw), tget_smoke(NAME).replace(**kw)


def _gated(jp, value=0.8):
    """The JAX params with every cross-attention gate set to ``value``."""
    groups = {k: (dict(v, gate=jnp.full_like(v["gate"], value))
                  if "gate" in v else v) for k, v in jp["groups"].items()}
    return dict(jp, groups=groups)


def _models(variant="CA2", seed=0):
    jcfg, tcfg = _configs(variant)
    jm = jbuild(jcfg)
    jp = _gated(jm.init_params(jax.random.PRNGKey(seed)))
    return jcfg, jm, jp, build_model(tcfg), params_from_numpy(_np(jp),
                                                              device="cpu")


def _images(rng, B, cfg):
    return rng.standard_normal((B, cfg.n_image_tokens, cfg.d_vision)
                               ).astype(np.float32)


@pytest.mark.parametrize("query", [(2, 5), (3,)])
def test_cross_kv_and_cross_attn_match_reference(query):
    jcfg, tcfg = _configs()
    spec = jattn.attn_spec(jcfg)
    rng = np.random.default_rng(1)
    p = {k: (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
         for k, s in spec.items()}
    B = query[0]
    ctx = rng.standard_normal((B, 8, jcfg.d_model)).astype(np.float32)
    x = rng.standard_normal(query + (jcfg.d_model,)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jk, jv = jattn.cross_kv(jp, jnp.asarray(ctx))
    ref = jattn.cross_attn(jp, jnp.asarray(x), jk, jv, jcfg)
    tp = {k: t(v) for k, v in p.items()}
    k, v = tattn.cross_kv(tp, t(ctx))
    close(k, jk, ATTN_TOL)
    close(v, jv, ATTN_TOL)
    got = tattn.cross_attn(tp, t(x), k, v, tcfg)
    assert got.shape == query + (jcfg.d_model,)
    close(got, ref, ATTN_TOL)


def test_params_from_numpy_converts_cross_layers():
    jcfg, _, jp, tm, tp = _models("CAAAA5", seed=2)
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    assert tp["layers"][0]["gate"].shape == () and "gate" not in tp[
        "layers"][1]
    assert float(tp["layers"][0]["gate"]) == pytest.approx(0.8)
    assert float(port["layers"][0]["gate"]) == 0.0  # the JAX init: zeros
    np.testing.assert_array_equal(tp["vision_proj"].numpy(),
                                  np.asarray(jp["vision_proj"]))
    assert tm.n_cross_layers == 1 and tm.n_attn_layers == 4
    assert tm.slot == [0, 0, 1, 2, 3]


def _pools(cfg, tm, B, pps):
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = np.zeros((tm.n_attn_layers, B * pps + 1, cfg.page_size,
                     cfg.n_kv_heads, cfg.resolved_head_dim), np.float32)
    cross = np.zeros((tm.n_cross_layers, B, cfg.n_image_tokens,
                      cfg.n_kv_heads, cfg.resolved_head_dim), np.float32)
    return tables, pool, cross


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_prefill_and_decode_logits_match_reference(variant):
    jcfg, jm, jp, tm, tp = _models(variant, seed=3)
    rng = np.random.default_rng(3)
    B, S = 2, 19
    lens = np.array([19, 11], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    img = _images(rng, B, jcfg)
    tables, pool, _ = _pools(jcfg, tm, B, 4)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens),
                         extra={"image_embeds": jnp.asarray(img)},
                         impl="ref")
    ref, feed = [np.asarray(jl)], []
    for _ in range(4):
        feed.append(rng.integers(0, jcfg.vocab_size, B).astype(np.int32))
        jl, jst = jm.decode_step(jp, jnp.asarray(feed[-1]), jst, impl="ref")
        ref.append(np.asarray(jl))
    for impl in ("kernel", "ref"):
        st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
              "v_pages": t(pool)}
        logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                                extra={"image_embeds": t(img)}, impl=impl)
        close(logits, ref[0], LOGIT_TOL)
        close(st["cross_k"], jst["cross_k"], LOGIT_TOL)
        close(st["cross_v"], jst["cross_v"], LOGIT_TOL)
        for i, tok in enumerate(feed):
            logits, st = tm.decode_step(tp, t(tok).long(), st, impl=impl)
            close(logits, ref[i + 1], LOGIT_TOL)


# (q_start, q_lens) per chunk step of two rows; row 1 of step 0 is dead
# (posing as a resume, as the engine's padding rows do)
CHUNK_STEPS = [((0, 1), (8, 0)),  # partial: row 0 at its first chunk
               ((8, 0), (8, 8)),  # partial: row 1 at its first chunk
               ((16, 8), (3, 8)),  # reuse
               ((19, 16), (0, 2))]  # reuse, row 0 dead


@pytest.mark.parametrize("fresh", [False, True], ids=["zeros", "no state"])
@pytest.mark.parametrize("variant", ["CA2", "CAAAA5"])
def test_model_prefill_chunk_cross_modes_match_reference(variant, fresh):
    """The chunk steps above from a state holding zero cross K/V (as the
    engine's); with ``no state`` the first step projects every row
    (``full``), its dead row's image too.  Then 3 decode steps."""
    jcfg, jm, jp, tm, tp = _models(variant, seed=4)
    rng = np.random.default_rng(4)
    B = 2
    tokens = rng.integers(0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    img = _images(rng, B, jcfg)
    tables, pool, cross = _pools(jcfg, tm, B, 4)
    jst = {"tables": jnp.asarray(tables), "k_pages": jnp.asarray(pool),
           "v_pages": jnp.asarray(pool)}
    st = {"tables": t(tables), "k_pages": t(pool), "v_pages": t(pool)}
    if not fresh:
        jst.update(cross_k=jnp.asarray(cross), cross_v=jnp.asarray(cross))
        st.update(cross_k=t(cross), cross_v=t(cross))
    for starts, q_lens in CHUNK_STEPS:
        starts, q_lens = np.array(starts, np.int32), np.array(q_lens,
                                                              np.int32)
        C = max(int(q_lens.max()), 1)
        chunk = np.stack([tokens[b, s:s + C] for b, s in enumerate(starts)])
        jl, jst = jm.prefill_chunk(
            jp, jnp.asarray(chunk), jst, jnp.asarray(starts),
            jnp.asarray(q_lens), extra={"image_embeds": jnp.asarray(img)},
            impl="ref")
        logits, st = tm.prefill_chunk(
            tp, t(chunk).long(), st, t(starts), t(q_lens),
            extra={"image_embeds": t(img)})
        rows = q_lens > 0
        close(logits.numpy()[rows], np.asarray(jl)[rows], LOGIT_TOL)
        close(st["cross_k"], jst["cross_k"], LOGIT_TOL)
        close(st["cross_v"], jst["cross_v"], LOGIT_TOL)
    jst["pos"] = jnp.array([19, 18], jnp.int32)
    st["pos"] = torch.tensor([19, 18], dtype=torch.int32)
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jst = jm.decode_step(jp, jnp.asarray(tok), jst, impl="ref")
        logits, st = tm.decode_step(tp, t(tok).long(), st)
        close(logits, jl, LOGIT_TOL)


# -- the engine ---------------------------------------------------------------
PROMPTS = [[1, 2, 3, 4, 5, 6, 7] * 2, [11, 12, 13], [9] * 25, [4, 5]]


@pytest.fixture(scope="module")
def weights():
    _, _, jp, _, tp = _models(seed=7)
    return jp, tp


def _extras(n, seed=7):
    rng = np.random.default_rng(seed)
    return [{"image_embeds": _images(rng, 1, _configs()[0])[0]}
            for _ in range(n)]


def _serve(eng, R, prompts, max_new, extras):
    reqs = [R(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, extras, max_steps=500)
    return reqs


@pytest.mark.parametrize("knobs", [
    dict(max_slots=3),
    dict(max_slots=4, prefill_chunk=8),
    dict(max_slots=4, prefill_chunk=13, pool_tokens=96),  # preemption
], ids=["monolithic", "chunked", "preemption"])
def test_engine_tokens_equal_reference(weights, knobs):
    """Four requests, each with its own image, mixed lengths; the chunked
    engines' steps mix first chunks with resumes (partial cross mode)."""
    jp, tp = weights
    max_new = 20 if "pool_tokens" in knobs else 6
    jeng = JEngine(_configs()[0], jp, impl="ref", rng=jax.random.PRNGKey(7),
                   max_seq_len=64, **knobs)
    eng = Engine(_configs()[1], tp, device="cpu", max_seq_len=64, **knobs)
    ref = _serve(jeng, JRequest, PROMPTS, max_new, _extras(4))
    got = _serve(eng, Request, PROMPTS, max_new, _extras(4))
    assert all(r.status is Status.FINISHED for r in got)
    assert [r.output for r in got] == [r.output for r in ref]
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    if "pool_tokens" in knobs:
        assert jeng.scheduler.preempted >= 1
    # the admitted slots' image K/V, projected in the port as in JAX
    close(eng.state["cross_k"], jeng.state["cross_k"], LOGIT_TOL)


def test_engine_baseline_equals_paged_reference(weights):
    """The port's contiguous baseline runs the ``C`` layers in decode (the
    JAX baseline does not: ``test_jax_baseline_skips_cross_layers``)."""
    jp, tp = weights
    jeng = JEngine(_configs()[0], jp, impl="ref", rng=jax.random.PRNGKey(7),
                   max_slots=3, max_seq_len=64)
    eng = Engine(_configs()[1], tp, device="cpu", paged=False, max_slots=3,
                 max_seq_len=64)
    ref = _serve(jeng, JRequest, PROMPTS, 6, _extras(4))
    got = _serve(eng, Request, PROMPTS, 6, _extras(4))
    assert [r.output for r in got] == [r.output for r in ref]


def test_fork_copies_the_cross_rows(weights):
    """A parent forked after 3 tokens into a greedy child: the child's
    slot holds the parent's image K/V, and both engines' children and
    parents decode to the same tokens."""
    jp, tp = weights
    knobs = dict(max_slots=2, max_seq_len=64)
    out = []
    for e, R in ((JEngine(_configs()[0], jp, impl="ref", **knobs),
                  JRequest),
                 (Engine(_configs()[1], tp, device="cpu", **knobs),
                  Request)):
        parent = R(prompt=PROMPTS[0], max_new_tokens=10)
        e.add_request(parent, _extras(1)[0])
        for _ in range(3):
            e.step()
        child = e.fork_request(parent, max_new_tokens=6)
        ck = np.asarray(e.state["cross_k"])
        np.testing.assert_array_equal(ck[:, child.slot], ck[:, parent.slot])
        assert np.abs(ck[:, child.slot]).max() > 0
        for _ in range(20):
            if parent.done and child.done:
                break
            e.step()
        out.append((parent.output, child.output))
    assert out[1] == out[0]


def test_engine_refusals():
    cfg = _configs()[1]
    eng = Engine(cfg, device="cpu", max_slots=2, max_seq_len=32)
    good = {"image_embeds": np.zeros((cfg.n_image_tokens, cfg.d_vision),
                                     np.float32)}
    for extra in (None, {}, {"image": good["image_embeds"]},
                  {"image_embeds": np.zeros((cfg.n_image_tokens + 1,
                                             cfg.d_vision), np.float32)},
                  {"image_embeds": np.zeros((1, cfg.n_image_tokens,
                                             cfg.d_vision), np.float32)}):
        with pytest.raises(InvalidRequest):
            eng.add_request(Request(prompt=[1, 2], max_new_tokens=2), extra)
    assert not eng.scheduler.waiting  # nothing held
    eng.add_request(Request(prompt=[1, 2], max_new_tokens=2), good)
    with pytest.raises(EngineConfigError) as port:
        Engine(cfg, device="cpu", prefix_cache=True)
    with pytest.raises(JEngineConfigError) as ref:
        JEngine(_configs()[0], prefix_cache=True)
    assert str(port.value) == str(ref.value)  # the JAX message


def test_jax_baseline_skips_cross_layers():
    """The JAX baseline's ``_decode_contiguous`` runs only 'A'/'W' codes:
    a 'C' layer gets its MLP and not its attention.  Smoke VLM (pattern
    CA), f32, PRNGKey(7) with the gates at 0.8, 2 slots, two 12-token
    prompts (numpy seed 7), 8 greedy tokens: the paged JAX engine and the
    port's baseline agree, the JAX baseline's tokens differ."""
    jcfg, tcfg = _configs()
    jp = _gated(jbuild(jcfg).init_params(jax.random.PRNGKey(7)))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).tolist()
               for _ in range(2)]
    extras = [{"image_embeds": _images(rng, 1, jcfg)[0]} for _ in range(2)]
    knobs = dict(max_slots=2, max_seq_len=64)
    runs = {}
    for key, e, R in (
            ("paged", JEngine(jcfg, jp, impl="ref", **knobs), JRequest),
            ("jax baseline", JEngine(jcfg, jp, impl="ref", paged=False,
                                     **knobs), JRequest),
            ("port baseline", Engine(tcfg, params_from_numpy(
                _np(jp), device="cpu"), device="cpu", paged=False, **knobs),
             Request)):
        runs[key] = [r.output for r in _serve(e, R, prompts, 8, extras)]
    print(runs)
    assert runs["port baseline"] == runs["paged"]
    assert runs["jax baseline"] != runs["paged"]
    # prefill runs the 'C' layers on both: the first tokens agree
    assert [o[0] for o in runs["jax baseline"]] == [o[0]
                                                    for o in runs["paged"]]
