"""PyTorch port: the ``rglru`` family (RecurrentGemma's 'R' and 'W'
layers) against the JAX package, from numpy inputs and the JAX weights.

- (a) The RG-LRU block: ``rglru_train`` (the causal width-4 conv and the
  doubling scan) and ``rglru_decode`` against ``repro.models.rglru``, and
  the prefill's final state against the JAX model's
  ``_rglru_final_state`` on rows of equal length, at ``ATTN_TOL`` for S up
  to 80; the GeGLU MLP (``activation="gelu"``, tanh form) against
  ``layers.apply_mlp``; R-layer weight conversion.
- (b) Smoke models (``RW``; ``RRW`` at 3 and 6 layers, and at head dim
  256, window 64 so the rings wrap): prefill logits and teacher-forced
  decode steps against the JAX ``prefill``/``decode_step`` at
  ``LOGIT_TOL``, on the port's kernel path (K4's and K1's plain versions)
  and its oracle path, the JAX side by its oracles and, once, by the
  Pallas K1 in interpret mode.
- (c) A padded wave: a short row's recurrent state, and its decode
  logits, equal those of the same row prefilled alone.  The JAX package
  takes every row's state at the padded end instead (its fault, measured
  by the last test), so it is compared only where its answer is well
  defined: rows of one length.
- (d) The engine: greedy tokens, steps and ``memory_report`` equal the
  JAX ``Engine(impl="ref")`` on waves of equal-length prompts decoding
  past the window; ``prefill_chunk`` and ``prefix_cache`` refused for
  recurrent layers, as the JAX engine refuses them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.errors import EngineConfigError as JEngineConfigError
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models.api import build_model as jbuild
from repro.models.spec import materialize as jmaterialize
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trglru
from repro_torch.serving import Engine, Request

from _torch_helpers import (ATTN_TOL, LOGIT_TOL, close,  # noqa: F401
                            pallas_interpret, t)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else t(v)
            for k, v in tree.items()}


def _block(seed=0):
    """The smoke config and one RG-LRU block's JAX weights (numpy)."""
    cfg = get_smoke("recurrentgemma-9b")
    p = jmaterialize(jrglru.rglru_spec(cfg), jax.random.PRNGKey(seed))
    return cfg, _np(p)


# -- (a) the block ------------------------------------------------------------
@pytest.mark.parametrize("S", [1, 2, 7, 33, 80])
def test_rglru_train_matches_reference(S):
    cfg, p = _block(S)
    x = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ref = jrglru.rglru_train(jax.tree_util.tree_map(jnp.asarray, p),
                             jnp.asarray(x), cfg)
    close(trglru.rglru_train(_torch(p), t(x), tget_smoke(
        "recurrentgemma-9b")), ref, ATTN_TOL)


def test_linear_scan_equals_the_recurrence():
    rng = np.random.default_rng(1)
    log_a = -rng.uniform(0, 3, (2, 37, 5))
    b = rng.standard_normal((2, 37, 5))
    h, want = np.zeros((2, 5)), []
    for s in range(37):
        h = np.exp(log_a[:, s]) * h + b[:, s]
        want.append(h)
    close(trglru.linear_scan(t(log_a), t(b)), np.stack(want, 1), 1e-12)


def test_rglru_decode_matches_reference():
    cfg, p = _block(3)
    rng = np.random.default_rng(3)
    w = cfg.lru_width or cfg.d_model
    state = {"h": rng.standard_normal((3, w)).astype(np.float32),
             "conv": rng.standard_normal(
                 (3, cfg.conv1d_width - 1, w)).astype(np.float32) * 0.3}
    x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    jst = jax.tree_util.tree_map(jnp.asarray, state)
    tst = _torch(state)
    for _ in range(4):  # the state carried over steps
        ref, jst = jrglru.rglru_decode(jp, jnp.asarray(x), jst, cfg)
        out, tst = trglru.rglru_decode(_torch(p), t(x), tst, cfg)
        close(out, ref, ATTN_TOL)
        for k in ("h", "conv"):
            close(tst[k], jst[k], ATTN_TOL)
        x = np.asarray(ref)


@pytest.mark.parametrize("S", [1, 3, 4, 40, 80])
def test_final_state_matches_reference_on_equal_rows(S):
    """All rows of the full length: the JAX model's state at the padded
    end is each row's own.  S < cw - 1 takes zeros before position 0."""
    cfg, p = _block(10 + S)
    jm = jbuild(cfg)
    h = np.random.default_rng(S).standard_normal(
        (2, S, cfg.d_model)).astype(np.float32)
    ref = jm._rglru_final_state(jax.tree_util.tree_map(jnp.asarray, p),
                                jnp.asarray(h), cfg)
    out, st = trglru.rglru_prefill(_torch(p), t(h),
                                   torch.full((2,), S, dtype=torch.int32),
                                   cfg)
    close(out, trglru.rglru_train(_torch(p), t(h), cfg), 0.0)
    for k in ("h", "conv"):
        assert tuple(st[k].shape) == ref[k].shape
        close(st[k], ref[k], ATTN_TOL)


def test_final_state_is_each_rows_own_in_a_padded_wave():
    """A row of 12 tokens beside one of 20: its state equals its state
    prefilled alone (to rounding of the other rows' matmuls)."""
    cfg, p = _block(5)
    h = np.random.default_rng(5).standard_normal(
        (2, 20, cfg.d_model)).astype(np.float32)
    lens = torch.tensor([12, 20], dtype=torch.int32)
    _, st = trglru.rglru_prefill(_torch(p), t(h), lens, cfg)
    for b, n in enumerate((12, 20)):
        _, alone = trglru.rglru_prefill(
            _torch(p), t(h[b:b + 1, :n]),
            torch.tensor([n], dtype=torch.int32), cfg)
        for k in ("h", "conv"):
            assert torch.allclose(st[k][b], alone[k][0], rtol=0, atol=1e-6)


def test_geglu_mlp_matches_reference():
    cfg = get_smoke("recurrentgemma-9b")
    assert cfg.activation == "gelu"
    p = _np(jmaterialize(jlayers.mlp_spec(cfg), jax.random.PRNGKey(4)))
    assert set(p) == {"wg", "wu", "wd"}  # gated: GeGLU
    x = np.random.default_rng(4).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32) * 3
    ref = jlayers.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), cfg)
    close(tlayers.apply_mlp(_torch(p), t(x), tget_smoke(
        "recurrentgemma-9b")), ref, ATTN_TOL)


# -- (b) smoke models ----------------------------------------------------------
VARIANTS = {"RW": {}, "RRW3": dict(n_layers=3, layer_pattern="RRW"),
            "RRW6": dict(n_layers=6, layer_pattern="RRW"),
            "RRW5 D256": dict(n_layers=5, layer_pattern="RRW",
                              head_dim=256)}


def _configs(name):
    """(JAX config, port config) of a recurrentgemma-9b smoke variant."""
    kw = VARIANTS[name]
    return (get_smoke("recurrentgemma-9b").replace(**kw),
            tget_smoke("recurrentgemma-9b").replace(**kw))


def _models(name, seed=0):
    jcfg, tcfg = _configs(name)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, build_model(tcfg), params_from_numpy(_np(jp),
                                                              device="cpu")


def test_params_from_numpy_converts_r_layers():
    """RRW at 5 layers: one scanned group of 'RRW' and the remainder 'RR';
    the port's layers come out in the pattern's order, 'R' layers with a
    ``rec`` dict, shaped as the port's own spec."""
    jcfg, _, jp, tm, tp = _models("RRW5 D256", seed=3)
    assert set(jp["groups"]) == {"0R", "1R", "2W"}
    assert set(jp["rem"]) == {"0R", "1R"}
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    assert [("rec" in p, "attn" in p) for p in tp["layers"]] == [
        (c == "R", c == "W") for c in jcfg.pattern()]
    np.testing.assert_array_equal(
        tp["layers"][1]["rec"]["wa"].numpy(),
        np.asarray(jp["groups"]["1R"]["rec"]["wa"][0]))
    np.testing.assert_array_equal(tp["layers"][4]["rec"]["a_log"].numpy(),
                                  np.asarray(jp["rem"]["1R"]["rec"]["a_log"]))
    # the port's own Λ init: a = σ(Λ) in [0.9, 0.999], as the reference's
    a = torch.sigmoid(port["layers"][0]["rec"]["a_log"])
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6


def _state(cfg, tm, B, lens, pps):
    P = cfg.page_size
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = np.zeros((tm.n_attn_layers, B * pps + 1, P, cfg.n_kv_heads,
                     cfg.resolved_head_dim), np.float32)
    return tables, pool


def _jax_state(jm, jcfg, B, lens, tables, pool):
    n_r = jcfg.pattern().count("R")
    rec = {"R": jax.tree_util.tree_map(
        lambda a: jnp.zeros((n_r,) + a.shape, a.dtype),
        jrglru.rglru_init_state(B, jcfg))}
    return {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
            "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool),
            "rec": rec}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_model_prefill_and_decode_logits_match_reference(name):
    """Rows of one length past the window (the rings wrap in prefill),
    then 10 teacher-forced decode steps."""
    jcfg, jm, jp, tm, tp = _models(name)
    rng = np.random.default_rng(7)
    B, S, steps = 2, 75, 10
    assert S > jcfg.window + jcfg.page_size
    lens = np.full((B,), S, np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pps = -(-jcfg.window // jcfg.page_size) + 1  # the ring
    tables, pool = _state(jcfg, tm, B, lens, pps)
    jst = _jax_state(jm, jcfg, B, lens, tables, pool)
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
        for k in ("h", "conv"):
            close(st["rec"]["R"][k], jst["rec"]["R"][k], LOGIT_TOL)


def test_model_decode_matches_the_pallas_decode_kernel(pallas_interpret):
    """The JAX side's decode through its Pallas K1 (interpret mode) on the
    ring tables, past the window."""
    jcfg, jm, jp, tm, tp = _models("RRW3")
    rng = np.random.default_rng(8)
    B, S = 2, 70
    lens = np.full((B,), S, np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pps = -(-jcfg.window // jcfg.page_size) + 1
    tables, pool = _state(jcfg, tm, B, lens, pps)
    jst = _jax_state(jm, jcfg, B, lens, tables, pool)
    _, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                        lens=jnp.asarray(lens), impl="ref")
    st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
          "v_pages": t(pool)}
    _, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens))
    for _ in range(3):
        tok = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
        jl, jst = jm.decode_step(jp, jnp.asarray(tok), jst, impl="pallas",
                                 interpret=True, pages_per_block=2,
                                 num_splits=2, backend="tpu")
        logits, st = tm.decode_step(tp, t(tok).long(), st,
                                    pages_per_block=2, num_splits=2)
        close(logits, jl, LOGIT_TOL)


# -- (c) a padded wave ---------------------------------------------------------
@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_padded_wave_gives_each_row_its_own_state(impl):
    """Row 0 (12 tokens) prefilled beside a 20-token row, then 3 decode
    steps, against row 0 prefilled alone: equal recurrent state and
    logits."""
    jcfg, jm, jp, tm, tp = _models("RRW3", seed=4)
    rng = np.random.default_rng(4)
    lens = np.array([12, 20], np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    feed = [rng.integers(0, jcfg.vocab_size, 2) for _ in range(3)]
    pps = -(-jcfg.window // jcfg.page_size) + 1
    out = []
    for rows, n in (([0, 1], 20), ([0], 12)):
        tables, pool = _state(jcfg, tm, len(rows), lens[rows], pps)
        st = {"pos": t(lens[rows]), "tables": t(tables), "k_pages": t(pool),
              "v_pages": t(pool)}
        logits, st = tm.prefill(tp, t(tokens[rows, :n]).long(), st,
                                lens=t(lens[rows]), impl=impl)
        seq = [logits[0]]
        rec = [{k: v[:, 0].clone() for k, v in st["rec"]["R"].items()}]
        for tok in feed:
            logits, st = tm.decode_step(tp, t(tok[rows]).long(), st,
                                        impl=impl)
            seq.append(logits[0])
        out.append((torch.stack(seq), rec[0]))
    (wave, wave_rec), (alone, alone_rec) = out
    for k in ("h", "conv"):
        assert torch.allclose(wave_rec[k], alone_rec[k], rtol=0, atol=1e-5)
    assert float((wave - alone).abs().max()) <= LOGIT_TOL


# -- (d) the engine ------------------------------------------------------------
WAVES = [[([3, 1, 4, 1, 5, 9, 2, 6] * 9, 12), ([7, 2] * 36, 12)],
         [([5] * 11, 6), ([8, 9, 10] * 3 + [4, 4], 9), ([2] * 11, 4)]]


@pytest.fixture(scope="module")
def weights():
    jcfg, _, jp, _, tp = _models("RRW3", seed=7)
    return jcfg, jp, tp


def test_engine_tokens_equal_reference(weights):
    """Two waves of equal-length prompts (72 tokens, past the window of 64;
    then 11), each admitted at once, decoding past the ring's wrap."""
    jcfg, jp, tp = weights
    knobs = dict(max_slots=3, max_seq_len=96)
    jeng = JEngine(jcfg, jp, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    eng = Engine(_configs("RRW3")[1], tp, device="cpu", pages_per_block=1,
                 num_splits=2, **knobs)
    assert eng.pages_per_seq == jeng.pages_per_seq == 9  # the ring
    for wave in WAVES:
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            reqs = [R(prompt=list(p), max_new_tokens=n) for p, n in wave]
            e.generate(reqs, max_steps=500)
            out.append(reqs)
        assert all(r.done for r in out[1])
        assert [r.output for r in out[1]] == [r.output for r in out[0]]
        assert eng.steps == jeng.steps
        assert eng.scheduler.preempted == jeng.scheduler.preempted == 0
        assert eng.memory_report() == jeng.memory_report()
    assert set(eng.state["rec"]["R"]) == {"h", "conv"}
    assert eng.state["rec"]["R"]["h"].shape == (2, 3, jcfg.d_model)


def test_engine_memory_report_mid_run_equals_reference(weights):
    jcfg, jp, tp = weights
    knobs = dict(max_slots=2, max_seq_len=64)
    jeng = JEngine(jcfg, jp, impl="ref", **knobs)
    eng = Engine(_configs("RRW3")[1], tp, device="cpu", **knobs)
    for e, R in ((jeng, JRequest), (eng, Request)):
        e.add_request(R(prompt=[1] * 12, max_new_tokens=4))
        e.step()
    assert (eng.pages_per_seq, eng.num_pages) == (jeng.pages_per_seq,
                                                 jeng.num_pages)
    assert eng.memory_report() == jeng.memory_report()


@pytest.mark.parametrize("knobs", [dict(prefill_chunk=8),
                                   dict(prefix_cache=True)],
                         ids=["prefill_chunk", "prefix_cache"])
def test_engine_refuses_chunks_and_prefix_cache_for_recurrent_layers(knobs):
    jcfg, tcfg = _configs("RW")
    with pytest.raises(JEngineConfigError):
        JEngine(jcfg, impl="ref", **knobs)
    with pytest.raises(EngineConfigError):
        Engine(tcfg, device="cpu", **knobs)
    # the recurrent gates, apart from the window's: an 'RA' pattern
    ra = dict(layer_pattern="RA", window=0)
    with pytest.raises(JEngineConfigError, match="recurrent"):
        JEngine(jcfg.replace(**ra), impl="ref", **knobs)
    with pytest.raises(EngineConfigError, match="recurrent"):
        Engine(tcfg.replace(**ra), device="cpu", **knobs)


def test_model_prefill_chunk_refuses_recurrent_layers():
    _, tcfg = _configs("RW")
    tm = build_model(tcfg)
    with pytest.raises(UnsupportedFeature):
        tm.prefill_chunk({}, torch.zeros((1, 4), dtype=torch.int64), {},
                         torch.zeros((1,), dtype=torch.int32),
                         torch.full((1,), 4, dtype=torch.int32))


def test_jax_padded_wave_takes_the_state_at_the_padded_end():
    """The JAX package's fault this port does not copy (not a port fault;
    the JAX package is not edited): its prefill takes every row's
    recurrent state at the padded end (``_rglru_final_state``:
    ``hs[:, -1]``), so a 12-token row prefilled beside a 20-token row gets
    another state than alone, and its next decode step other logits;
    its prefill logits (taken at each row's own last token) agree.  The
    port's row equals its row prefilled alone (the test above).  Smoke
    config ``RW``, f32, seed 0."""
    jcfg, jm, jp, _, _ = _models("RW")
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    tok = rng.integers(0, jcfg.vocab_size, 2).astype(np.int32)
    pps = -(-jcfg.window // jcfg.page_size) + 1
    out = {}
    for name, rows, n in (("wave", [0, 1], 20), ("alone", [0], 12)):
        lens = np.array([12, 20], np.int32)[rows]
        tables = np.arange(len(rows) * pps, dtype=np.int32).reshape(
            len(rows), 1, pps)
        pool = np.zeros((1, len(rows) * pps + 1, jcfg.page_size,
                         jcfg.n_kv_heads, jcfg.resolved_head_dim), np.float32)
        st = _jax_state(jm, jcfg, len(rows), lens, tables, pool)
        pre, st = jm.prefill(jp, jnp.asarray(tokens[rows, :n]), st,
                             lens=jnp.asarray(lens), impl="ref")
        h = np.asarray(st["rec"]["R"]["h"][:, 0])
        dec, _ = jm.decode_step(jp, jnp.asarray(tok[rows]), st, impl="ref")
        out[name] = (np.asarray(pre)[0], h, np.asarray(dec)[0])
    (p_w, h_w, d_w), (p_a, h_a, d_a) = out["wave"], out["alone"]
    errs = [float(np.abs(a - b).max()) for a, b in ((p_w, p_a), (h_w, h_a),
                                                    (d_w, d_a))]
    print(f"JAX padded wave vs alone, max|err|: prefill logits {errs[0]:.3e}"
          f", R-layer h {errs[1]:.3e}, next decode logits {errs[2]:.3e} "
          f"(|decode logit| max {float(np.abs(d_a).max()):.3f})")
    assert errs[0] <= LOGIT_TOL  # the prefill logits take each row's own
    assert errs[1] > 100 * ATTN_TOL and errs[2] > LOGIT_TOL  # the fault
