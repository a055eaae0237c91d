"""PyTorch port: the ``encdec`` family (whisper-medium) against the JAX
package, at smoke size (2 encoder and 2 decoder layers, d_model 256, 4
heads of 64, 16 audio frames, pages of 8), from numpy inputs and the JAX
weights.

With ``init_params`` weights the token embeddings have std 0.02 and the
sinusoidal positions added to them magnitude 1, so with tied embeddings
the greedy tokens follow the position and hardly the input: every test
here draws ``embed/tok`` at std 1.0 before either package uses it, and
the engine tests compare the logits of every sampled token beside the
tokens.

* the sinusoidal tables (the f64 one and the f32 closed form), the
  ungated GELU MLP, ``attn_train`` (full mask, causal, padding; K4's plain
  version over keys padded to whole tiles) and ``encode`` within
  ``ATTN_TOL``;
* model logits and cross K/V within ``LOGIT_TOL``: ``prefill`` then
  decode, on the paged state and on the contiguous one, and
  ``prefill_chunk`` through its three cross modes;
* the engine's greedy tokens and sampled logits against the paged JAX
  engine, monolithic, chunked and preempting; the contiguous baseline
  (``paged=False``) against the paged JAX engine; the JAX baseline fails
  on an encoder-decoder;
* ``fork_request`` copies the parent's cross rows; the refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.errors import EngineConfigError as JEngineConfigError
from repro.errors import InternalError as JInternalError
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import EngineConfigError, InvalidRequest
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.serving import Engine, Request, Status

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, t

NAME = "whisper-medium"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(**kw):
    return get_smoke(NAME).replace(**kw), tget_smoke(NAME).replace(**kw)


def _tok_std1(jp, seed):
    """The JAX params with ``embed/tok`` drawn at std 1.0."""
    tok = np.random.default_rng(seed).standard_normal(
        jp["embed"]["tok"].shape).astype(np.float32)
    return dict(jp, embed=dict(jp["embed"], tok=jnp.asarray(tok)))


def _models(seed=0, **kw):
    jcfg, tcfg = _configs(**kw)
    jm = jbuild(jcfg)
    jp = _tok_std1(jm.init_params(jax.random.PRNGKey(seed)), seed)
    return jcfg, jm, jp, build_model(tcfg), params_from_numpy(_np(jp),
                                                              device="cpu")


def _frames(rng, B, cfg):
    return rng.standard_normal((B, cfg.n_audio_frames, cfg.d_model)
                               ).astype(np.float32)


# -- layers -------------------------------------------------------------------
@pytest.mark.parametrize("n,d", [(16, 256), (448, 1024), (1500, 1024)])
def test_sinusoidal_tables_match_reference(n, d):
    np.testing.assert_array_equal(
        tlayers.sinusoidal_positions(n, d).numpy(),
        np.asarray(jlayers.sinusoidal_positions(n, d)))
    pos = np.random.default_rng(n).integers(0, n, (3, 5)).astype(np.int32)
    close(tlayers.sinusoidal_at(t(pos), d),
          jlayers.sinusoidal_at(jnp.asarray(pos), d), ATTN_TOL)


def test_gelu_ungated_mlp_matches_reference():
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(2)
    p = {k: (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
         for k, s in jlayers.mlp_spec(jcfg).items()}
    assert set(p) == {"wu", "wd"}
    x = rng.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    ref = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), jcfg)
    close(tlayers.apply_mlp({k: t(v) for k, v in p.items()}, t(x), tcfg),
          ref, ATTN_TOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("S,causal,lens", [
    (16, False, None), (150, False, None), (150, True, None),
    (37, True, (37, 20)), (150, False, (150, 90))])
def test_attn_train_matches_reference(S, causal, lens, impl):
    """``causal=False`` with no ``lens`` is the encoder's full mask; at S
    150 K4's plain version pads the keys to 256 and only ``kv_len`` keeps
    the zero keys out of the softmax."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(S)
    p = {k: (rng.standard_normal(s.shape) * 0.05).astype(np.float32)
         for k, s in jattn.attn_spec(jcfg).items()}
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ln = None if lens is None else np.asarray(lens, np.int32)
    ref = jattn.attn_train({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jcfg, causal=causal,
                           lens=None if ln is None else jnp.asarray(ln))
    got = tattn.attn_train({k: t(v) for k, v in p.items()}, t(x), tcfg,
                           causal=causal, lens=None if ln is None else t(ln),
                           impl=impl)
    close(got, ref, ATTN_TOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_encode_matches_reference(impl):
    jcfg, jm, jp, tm, tp = _models(seed=1)
    fr = _frames(np.random.default_rng(1), 3, jcfg)
    ref = jm.encode(jp, jnp.asarray(fr))
    close(tm.encode(tp, t(fr), impl=impl), ref, ATTN_TOL)


def test_params_from_numpy_converts_encdec():
    jcfg, _, jp, tm, tp = _models(seed=2)
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    assert len(tp["enc"]) == jcfg.n_encoder_layers
    assert len(tp["dec"]) == jcfg.n_layers
    np.testing.assert_array_equal(
        tp["dec"][1]["cross_attn"]["wk"].numpy(),
        np.asarray(jp["dec"]["cross_attn"]["wk"][1]))
    assert set(tp["enc"][0]["mlp"]) == {"wu", "wd"}
    assert "bias" in tp["ln_f"]  # LayerNorm
    assert tm.n_cross_layers == tm.n_attn_layers == jcfg.n_layers
    assert tm.extra_key == "frames"
    assert tm.extra_shape == (jcfg.n_audio_frames, jcfg.d_model)


# -- the model ----------------------------------------------------------------
def _pools(cfg, B, pps):
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = np.zeros((cfg.n_layers, B * pps + 1, cfg.page_size,
                     cfg.n_kv_heads, cfg.resolved_head_dim), np.float32)
    cross = np.zeros((cfg.n_layers, B, cfg.n_audio_frames, cfg.n_kv_heads,
                      cfg.resolved_head_dim), np.float32)
    return tables, pool, cross


def _reference_run(jcfg, jm, jp, rng, tokens, lens, fr, steps=4):
    B = tokens.shape[0]
    tables, pool, _ = _pools(jcfg, B, 4)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens),
                         extra={"frames": jnp.asarray(fr)})
    ref, feed = [np.asarray(jl)], []
    for _ in range(steps):
        feed.append(rng.integers(0, jcfg.vocab_size, B).astype(np.int32))
        jl, jst = jm.decode_step(jp, jnp.asarray(feed[-1]), jst, impl="ref")
        ref.append(np.asarray(jl))
    return ref, feed, jst, tables, pool


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_model_prefill_and_decode_logits_match_reference(impl):
    jcfg, jm, jp, tm, tp = _models(seed=3)
    rng = np.random.default_rng(3)
    B, S = 2, 19
    lens = np.array([19, 11], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    fr = _frames(rng, B, jcfg)
    ref, feed, jst, tables, pool = _reference_run(jcfg, jm, jp, rng, tokens,
                                                  lens, fr)
    st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
          "v_pages": t(pool)}
    logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                            extra={"frames": t(fr)}, impl=impl)
    close(logits, ref[0], LOGIT_TOL)
    assert st["cross_k"].shape == (jcfg.n_layers, B, jcfg.n_audio_frames,
                                   jcfg.n_kv_heads, jcfg.resolved_head_dim)
    close(st["cross_k"], jst["cross_k"], LOGIT_TOL)
    close(st["cross_v"], jst["cross_v"], LOGIT_TOL)
    for i, tok in enumerate(feed):
        logits, st = tm.decode_step(tp, t(tok).long(), st, impl=impl)
        close(logits, ref[i + 1], LOGIT_TOL)
    # the paged pools hold the JAX K/V
    close(st["k_pages"], jst["k_pages"], LOGIT_TOL)


def test_model_on_the_contiguous_state_matches_reference():
    """The same prompts and decode steps through the contiguous baseline's
    state (buffer rows 2 and 0 of 3): the paged JAX model's logits."""
    jcfg, jm, jp, tm, tp = _models(seed=3)
    rng = np.random.default_rng(3)
    B, S = 2, 19
    lens = np.array([19, 11], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    fr = _frames(rng, B, jcfg)
    ref, feed, _, _, _ = _reference_run(jcfg, jm, jp, rng, tokens, lens, fr)
    buf = torch.zeros((jcfg.n_layers, 3, jcfg.n_kv_heads, 32,
                       jcfg.resolved_head_dim))
    slots = torch.tensor([2, 0])
    st = {"pos": t(lens), "k_buf": buf, "v_buf": buf.clone(), "slots": slots}
    logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                            extra={"frames": t(fr)})
    close(logits, ref[0], LOGIT_TOL)
    st = {"pos": t(lens), "k_buf": st["k_buf"][:, slots],
          "v_buf": st["v_buf"][:, slots], "cross_k": st["cross_k"],
          "cross_v": st["cross_v"]}
    for i, tok in enumerate(feed):
        logits, st = tm.decode_step(tp, t(tok).long(), st)
        close(logits, ref[i + 1], LOGIT_TOL)


# (q_start, q_lens) per chunk step of two rows; row 1 of step 0 is dead
# (posing as a resume, as the engine's padding rows do)
CHUNK_STEPS = [((0, 1), (8, 0)),  # partial: row 0 at its first chunk
               ((8, 0), (8, 8)),  # partial: row 1 at its first chunk
               ((16, 8), (3, 8)),  # reuse
               ((19, 16), (0, 2))]  # reuse, row 0 dead


@pytest.mark.parametrize("fresh", [False, True], ids=["zeros", "no state"])
def test_model_prefill_chunk_cross_modes_match_reference(fresh):
    """The chunk steps above from a state holding zero cross K/V (as the
    engine's); with ``no state`` the first step encodes every row
    (``full``), its dead row's frames too.  Then 3 decode steps."""
    jcfg, jm, jp, tm, tp = _models(seed=4)
    rng = np.random.default_rng(4)
    B = 2
    tokens = rng.integers(0, jcfg.vocab_size, (B, 24)).astype(np.int32)
    fr = _frames(rng, B, jcfg)
    tables, pool, cross = _pools(jcfg, B, 4)
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
            jnp.asarray(q_lens), extra={"frames": jnp.asarray(fr)},
            impl="ref")
        logits, st = tm.prefill_chunk(tp, t(chunk).long(), st, t(starts),
                                      t(q_lens), extra={"frames": t(fr)})
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
    return [{"frames": _frames(rng, 1, _configs()[0])[0]} for _ in range(n)]


def _record(eng):
    """Record the logits of every row ``eng`` samples, by request."""
    eng.by_request = {}
    plain = eng._sample_and_append

    def wrapped(reqs, logits, first):
        rows = np.asarray(logits.cpu() if torch.is_tensor(logits) else logits,
                          np.float32)
        for r, row in zip(reqs, rows):
            eng.by_request.setdefault(id(r), []).append(row)
        return plain(reqs, logits, first)
    eng._sample_and_append = wrapped
    return eng


def _serve(eng, R, prompts, max_new, extras):
    reqs = [R(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, extras, max_steps=500)
    return reqs


def _logits(eng, reqs):
    return [np.stack(eng.by_request[id(r)]) for r in reqs]


@pytest.mark.parametrize("knobs", [
    dict(max_slots=3),
    dict(max_slots=4, prefill_chunk=8),
    dict(max_slots=4, prefill_chunk=13, pool_tokens=96),  # preemption
], ids=["monolithic", "chunked", "preemption"])
def test_engine_tokens_and_logits_equal_reference(weights, knobs):
    """Four requests, each with its own frames, mixed lengths; the chunked
    engines' steps mix first chunks with resumes (partial cross mode).
    Every sampled token's logits agree within ``LOGIT_TOL``."""
    jp, tp = weights
    max_new = 20 if "pool_tokens" in knobs else 6
    jeng = _record(JEngine(_configs()[0], jp, impl="ref",
                           rng=jax.random.PRNGKey(7), max_seq_len=64,
                           **knobs))
    eng = _record(Engine(_configs()[1], tp, device="cpu", max_seq_len=64,
                         **knobs))
    ref = _serve(jeng, JRequest, PROMPTS, max_new, _extras(4))
    got = _serve(eng, Request, PROMPTS, max_new, _extras(4))
    assert all(r.status is Status.FINISHED for r in got)
    assert [r.output for r in got] == [r.output for r in ref]
    for a, b in zip(_logits(eng, got), _logits(jeng, ref)):
        close(a, b, LOGIT_TOL)
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    if "pool_tokens" in knobs:
        assert jeng.scheduler.preempted >= 1
    close(eng.state["cross_k"], jeng.state["cross_k"], LOGIT_TOL)


def test_tokens_depend_on_the_input(weights):
    """With ``embed/tok`` at std 1.0, two requests with different prompts
    and frames get different greedy tokens (at std 0.02 the position
    decides them: ``test_jax_init_tokens_follow_the_position``)."""
    _, tp = weights
    eng = Engine(_configs()[1], tp, device="cpu", max_slots=2,
                 max_seq_len=64)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, 12).tolist() for _ in range(2)]
    a, b = _serve(eng, Request, prompts, 4, _extras(2, seed=8))
    assert a.output != b.output


def test_jax_init_tokens_follow_the_position():
    """On the JAX ``init_params`` weights (``tok`` std 0.02) two different
    prompts with different frames get the same greedy tokens: the
    sinusoidal positions (magnitude 1) decide the tied unembedding."""
    jcfg, _ = _configs()
    jeng = JEngine(jcfg, impl="ref", rng=jax.random.PRNGKey(7), max_slots=2,
                   max_seq_len=64)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, 12).tolist()
               for _ in range(2)]
    a, b = _serve(jeng, JRequest, prompts, 4, _extras(2, seed=8))
    print(a.output, b.output)
    assert a.output == b.output


def test_engine_baseline_equals_paged_reference(weights):
    """The port's contiguous baseline serves the encoder-decoder through
    the model's loop (the JAX baseline fails:
    ``test_jax_baseline_fails_on_encdec``): its tokens and sampled logits
    equal the paged JAX engine's."""
    jp, tp = weights
    jeng = _record(JEngine(_configs()[0], jp, impl="ref",
                           rng=jax.random.PRNGKey(7), max_slots=3,
                           max_seq_len=64))
    eng = _record(Engine(_configs()[1], tp, device="cpu", paged=False,
                         max_slots=3, max_seq_len=64))
    ref = _serve(jeng, JRequest, PROMPTS, 6, _extras(4))
    got = _serve(eng, Request, PROMPTS, 6, _extras(4))
    assert [r.output for r in got] == [r.output for r in ref]
    for a, b in zip(_logits(eng, got), _logits(jeng, ref)):
        close(a, b, LOGIT_TOL)


def test_jax_baseline_fails_on_encdec():
    """The JAX baseline's ``_decode_contiguous`` assumes a
    ``TransformerModel``: smoke whisper, ``Engine(paged=False,
    impl="ref")``, 2 slots, two 12-token prompts with frames (numpy seed
    7): the first decode step raises ``InternalError`` wrapping an
    ``AttributeError`` (``_per_layer_params``).  The paged JAX engine
    serves the same requests."""
    jcfg, _ = _configs()
    prompts = [np.random.default_rng(7).integers(0, jcfg.vocab_size,
                                                 12).tolist()
               for _ in range(2)]
    knobs = dict(impl="ref", rng=jax.random.PRNGKey(7), max_slots=2,
                 max_seq_len=64)
    jeng = JEngine(jcfg, paged=False, **knobs)
    with pytest.raises(JInternalError) as err:
        _serve(jeng, JRequest, prompts, 4, _extras(2))
    assert isinstance(err.value.__cause__, AttributeError)
    assert "_per_layer_params" in str(err.value)
    ok = _serve(JEngine(jcfg, **knobs), JRequest, prompts, 4, _extras(2))
    assert all(len(r.output) == 4 for r in ok)


def test_fork_copies_the_cross_rows(weights):
    """A parent forked after 3 tokens into a greedy child: the child's
    slot holds the parent's cross K/V, and both engines' children and
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
    F, d = cfg.n_audio_frames, cfg.d_model
    good = {"frames": np.zeros((F, d), np.float32)}
    for extra in (None, {}, {"image_embeds": good["frames"]},
                  {"frames": np.zeros((F + 1, d), np.float32)},
                  {"frames": np.zeros((1, F, d), np.float32)}):
        with pytest.raises(InvalidRequest):
            eng.add_request(Request(prompt=[1, 2], max_new_tokens=2), extra)
    assert not eng.scheduler.waiting  # nothing held
    eng.add_request(Request(prompt=[1, 2], max_new_tokens=2), good)
    with pytest.raises(EngineConfigError) as port:
        Engine(cfg, device="cpu", prefix_cache=True)
    with pytest.raises(JEngineConfigError) as ref:
        JEngine(_configs()[0], prefix_cache=True)
    assert str(port.value) == str(ref.value)  # the JAX message
