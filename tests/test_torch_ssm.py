"""PyTorch port: the ``xlstm`` family (xlstm-350m's mLSTM 'M' and sLSTM 'S'
blocks) against the JAX package, at smoke size (d_model 256, 4 heads of
64, pattern ``MS``), from numpy inputs and the JAX weights.

- (a) The blocks: ``mlstm_train`` (the parallel quadratic form),
  ``mlstm_decode``, ``slstm_train`` and ``slstm_decode`` against
  ``repro.models.ssm`` at ``ATTN_TOL``; the prefill's final states against
  the JAX model's ``_mlstm_final_state`` (a replay of ``mlstm_decode``
  per token; the port's is the closed form from the log-decay row) and
  ``_slstm_with_state`` on rows of equal length; the zero states.
- (b) Smoke models (``MS``; ``MMMS`` at 4 layers): prefill logits and
  teacher-forced decode steps against the JAX ``prefill`` /
  ``decode_step`` at ``LOGIT_TOL``.
- (c) A padded wave: a short row's states, decode logits and greedy
  tokens equal those of the row alone; the JAX package takes every row's
  state at the padded end (its fault, shown by the last test), so it is
  compared only on rows of one length.
- (d) The engine: greedy tokens and the logits of every sampled token
  equal the JAX engine's on waves of equal-length prompts, on the
  contiguous state (the config's ``paged_attention=False``) and the
  paged one; ``prefill_chunk`` and ``prefix_cache`` refused with the JAX
  messages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.errors import EngineConfigError as JEngineConfigError
from repro.models import ssm as jssm
from repro.models.api import build_model as jbuild
from repro.models.spec import materialize as jmaterialize
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import EngineConfigError
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import ssm as tssm
from repro_torch.serving import Engine, Request, Status

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, t

NAME = "xlstm-350m"


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _configs(**kw):
    return get_smoke(NAME).replace(**kw), tget_smoke(NAME).replace(**kw)


def _block(kind, seed=0):
    """The smoke config and one block's JAX weights (numpy)."""
    cfg = get_smoke(NAME)
    spec = jssm.mlstm_spec(cfg) if kind == "M" else jssm.slstm_spec(cfg)
    return cfg, _np(jmaterialize(spec, jax.random.PRNGKey(seed)))


def _x(S, B=2, seed=None):
    return np.random.default_rng(S if seed is None else seed).standard_normal(
        (B, S, get_smoke(NAME).d_model)).astype(np.float32)


# -- (a) the blocks -----------------------------------------------------------
@pytest.mark.parametrize("S", [1, 7, 33, 80])
def test_mlstm_train_matches_reference(S):
    cfg, p = _block("M", S)
    x = _x(S)
    ref = jssm.mlstm_train(_jax(p), jnp.asarray(x), cfg)
    close(tssm.mlstm_train(_torch(p), t(x), _configs()[1]), ref, ATTN_TOL)


@pytest.mark.parametrize("S", [1, 7, 33, 80])
def test_slstm_train_matches_reference(S):
    cfg, p = _block("S", S)
    x = _x(S)
    ref = jssm.slstm_train(_jax(p), jnp.asarray(x), cfg)
    close(tssm.slstm_train(_torch(p), t(x), _configs()[1]), ref, ATTN_TOL)


@pytest.mark.parametrize("kind", ["M", "S"])
def test_decode_steps_match_reference(kind):
    """Six decode steps from the zero state, the state compared after
    each."""
    cfg, p = _block(kind, 3)
    tcfg = _configs()[1]
    jinit, tinit, jdec, tdec = {
        "M": (jssm.mlstm_init_state, tssm.mlstm_init_state,
              jssm.mlstm_decode, tssm.mlstm_decode),
        "S": (jssm.slstm_init_state, tssm.slstm_init_state,
              jssm.slstm_decode, tssm.slstm_decode)}[kind]
    jst, st = jinit(2, cfg), tinit(2, tcfg)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jst.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
        for k, v in st.items()}
    for k in st:
        close(st[k], jst[k], 0)
    x = _x(6)
    for i in range(6):
        ref, jst = jdec(_jax(p), jnp.asarray(x[:, i]), jst, cfg)
        got, st = tdec(_torch(p), t(x[:, i]), st, tcfg)
        close(got, ref, ATTN_TOL)
        for k in st:
            close(st[k], jst[k], ATTN_TOL)


@pytest.mark.parametrize("S", [1, 5, 33, 80])
def test_prefill_final_states_match_reference(S):
    """Equal-length rows: the port's final states (mLSTM in closed form)
    against the JAX model's replay of the recurrence."""
    jcfg, tcfg = _configs()
    jm = jbuild(jcfg)
    x = _x(S, seed=S + 1)
    lens = torch.full((2,), S, dtype=torch.int32)
    _, pm = _block("M", S)
    ref = jm._mlstm_final_state(_jax(pm), jnp.asarray(x), jcfg)
    out, got = tssm.mlstm_prefill(_torch(pm), t(x), lens, tcfg)
    close(out, jssm.mlstm_train(_jax(pm), jnp.asarray(x), jcfg), ATTN_TOL)
    for k in ("C", "n", "m"):
        close(got[k], ref[k], ATTN_TOL)
    _, ps = _block("S", S)
    ref_out, ref = jm._slstm_with_state(_jax(ps), jnp.asarray(x), jcfg)
    out, got = tssm.slstm_prefill(_torch(ps), t(x), lens, tcfg)
    close(out, ref_out, ATTN_TOL)
    for k in ("c", "n", "h", "m"):
        close(got[k], ref[k], ATTN_TOL)


@pytest.mark.parametrize("kind", ["M", "S"])
def test_prefill_state_is_taken_at_each_rows_last_token(kind):
    """A row of 12 tokens padded to 40 beside a full row: its state equals
    that of the 12 tokens prefilled alone, and the JAX scan's over them."""
    jcfg, tcfg = _configs()
    jm = jbuild(jcfg)
    _, p = _block(kind, 5)
    x = _x(40, seed=5)
    fn = tssm.mlstm_prefill if kind == "M" else tssm.slstm_prefill
    _, wave = fn(_torch(p), t(x), torch.tensor([12, 40]), tcfg)
    _, alone = fn(_torch(p), t(x[:1, :12]), torch.tensor([12]), tcfg)
    ref = (jm._mlstm_final_state(_jax(p), jnp.asarray(x[:1, :12]), jcfg)
           if kind == "M" else
           jm._slstm_with_state(_jax(p), jnp.asarray(x[:1, :12]), jcfg)[1])
    for k in wave:
        close(wave[k][:1], alone[k], ATTN_TOL)
        close(wave[k][:1], ref[k], ATTN_TOL)


def test_params_from_numpy_converts_recurrent_layers():
    jcfg, tcfg = _configs(n_layers=4, layer_pattern="MMMS")
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(2))
    tm = build_model(tcfg)
    tp = params_from_numpy(_np(jp), device="cpu")
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    assert set(tp["layers"][0]) == {"ln1", "rec"}  # d_ff 0: no FFN
    assert "rz" in tp["layers"][3]["rec"] and "C" not in tm.codes
    np.testing.assert_array_equal(
        tp["layers"][1]["rec"]["wq"].numpy(),
        np.asarray(jp["groups"]["1M"]["rec"]["wq"][0]))
    assert tm.n_rec_layers == 4 and tm.n_attn_layers == 0
    assert tm.slot == [0, 1, 2, 0]
    rec = tm.init_rec_state(3)
    assert rec["M"]["C"].shape == (3, 3, 4, 64, 64)
    assert rec["S"]["h"].shape == (1, 3, 4, 64)


# -- (b) smoke models ---------------------------------------------------------
VARIANTS = {"MS": {}, "MMMS": dict(n_layers=4, layer_pattern="MMMS")}


def _models(variant="MS", seed=0):
    jcfg, tcfg = _configs(**VARIANTS[variant])
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, build_model(tcfg), params_from_numpy(_np(jp),
                                                              device="cpu")


def _jstate(jm, jcfg, B):
    one = {"M": jssm.mlstm_init_state, "S": jssm.slstm_init_state}
    rec = {}
    for code in "MS":
        n = jcfg.pattern().count(code)
        rec[code] = jax.tree_util.tree_map(
            lambda a: jnp.stack([a] * n), one[code](B, jcfg))
    return {"pos": jnp.zeros((B,), jnp.int32), "rec": rec}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_prefill_and_decode_logits_match_reference(variant):
    jcfg, jm, jp, tm, tp = _models(variant, seed=3)
    rng = np.random.default_rng(3)
    B, S = 2, 19
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), _jstate(jm, jcfg, B))
    logits, st = tm.prefill(tp, t(tokens).long(), {"pos": torch.zeros(
        (B,), dtype=torch.int32)})
    close(logits, jl, LOGIT_TOL)
    for code in "MS":
        for k in st["rec"][code]:
            close(st["rec"][code][k], jst["rec"][code][k], LOGIT_TOL)
    for _ in range(4):
        tok = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jst = jm.decode_step(jp, jnp.asarray(tok), jst, impl="ref")
        logits, st = tm.decode_step(tp, t(tok).long(), st)
        close(logits, jl, LOGIT_TOL)


# -- (c) the padded wave ------------------------------------------------------
def test_padded_wave_short_row_equals_the_row_alone():
    """The model: a 12-token row beside a 20-token row; its states and 3
    teacher-forced decode steps' logits equal those of the row alone."""
    _, _, _, tm, tp = _models(seed=7)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, 512, (2, 20))
    z = {"pos": torch.zeros((2,), dtype=torch.int32)}
    wl, wst = tm.prefill(tp, t(tokens), z, lens=torch.tensor([12, 20]))
    al, ast = tm.prefill(tp, t(tokens[:1, :12]), dict(z, pos=z["pos"][:1]))
    close(wl[:1], al, LOGIT_TOL)
    for code in "MS":
        for k in ast["rec"][code]:
            close(wst["rec"][code][k][:, :1], ast["rec"][code][k], LOGIT_TOL)
    for _ in range(3):
        tok = rng.integers(0, 512, 2)
        wl, wst = tm.decode_step(tp, t(tok), wst)
        al, ast = tm.decode_step(tp, t(tok[:1]), ast)
        close(wl[:1], al, LOGIT_TOL)


def _wave(eng, R, prompts, max_new):
    reqs = [R(prompt=list(p), max_new_tokens=max_new) for p in prompts]
    eng.generate(reqs, max_steps=200)
    return [r.output for r in reqs]


def test_engine_short_row_in_a_mixed_wave_equals_alone():
    """The port's engine: 12- and 20-token prompts in one wave give each
    request the tokens it gets alone."""
    _, _, _, _, tp = _models(seed=7)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 512, n).tolist() for n in (12, 20)]
    cfg = _configs()[1]
    wave = _wave(Engine(cfg, tp, device="cpu", max_slots=2, max_seq_len=64),
                 Request, prompts, 4)
    for p, out in zip(prompts, wave):
        eng = Engine(cfg, tp, device="cpu", max_slots=2, max_seq_len=64)
        assert _wave(eng, Request, [p], 4) == [out]


def test_jax_padded_wave_takes_the_state_at_the_padded_end():
    """The JAX package's xLSTM prefill takes every row's state at the
    padded end (``_mlstm_final_state`` and ``_slstm_with_state`` scan the
    whole padded wave): smoke ``MS``, f32, ``PRNGKey(7)``, prompts of 12
    and 20 tokens (numpy seed 7), 4 greedy tokens.  The 12-token row's
    tokens in the wave differ from its tokens alone; the 20-token row's
    do not."""
    jcfg, _ = _configs()
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (12, 20)]
    knobs = dict(impl="ref", max_slots=2, max_seq_len=64)
    wave = _wave(JEngine(jcfg, jp, **knobs), JRequest, prompts, 4)
    alone = [_wave(JEngine(jcfg, jp, **knobs), JRequest, [p], 4)[0]
             for p in prompts]
    print("wave", wave, "alone", alone)
    assert wave[0] != alone[0]
    assert wave[1] == alone[1]


# -- (d) the engine -----------------------------------------------------------
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


@pytest.mark.parametrize("paged", [None, True], ids=["contiguous", "paged"])
def test_engine_tokens_and_logits_equal_reference(paged):
    """Two waves of three equal-length prompts (16 and 24 tokens) on 3
    slots, 6 greedy tokens each."""
    jcfg, _, jp, _, tp = _models(seed=9)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, jcfg.vocab_size, n).tolist()
               for n in (16, 16, 16, 24, 24, 24)]
    knobs = dict(max_slots=3, max_seq_len=64, paged=paged)
    jeng = _record(JEngine(jcfg, jp, impl="ref", **knobs))
    eng = _record(Engine(_configs()[1], tp, device="cpu", **knobs))
    ref = [JRequest(prompt=list(p), max_new_tokens=6) for p in prompts]
    got = [Request(prompt=list(p), max_new_tokens=6) for p in prompts]
    jeng.generate(ref)
    eng.generate(got)
    assert eng.paged is jeng.paged is bool(paged)
    assert all(r.status is Status.FINISHED for r in got)
    assert [r.output for r in got] == [r.output for r in ref]
    assert eng.steps == jeng.steps
    for a, b in zip(got, ref):
        close(np.stack(eng.by_request[id(a)]),
              np.stack(jeng.by_request[id(b)]), LOGIT_TOL)


def test_engine_refuses_chunks_and_the_prefix_cache():
    jcfg, tcfg = _configs()
    for kw in (dict(prefill_chunk=8, paged=True),
               dict(prefix_cache=True, paged=True)):
        with pytest.raises(EngineConfigError) as port:
            Engine(tcfg, device="cpu", **kw)
        with pytest.raises(JEngineConfigError) as ref:
            JEngine(jcfg, **kw)
        assert str(port.value) == str(ref.value)
