"""PyTorch port: the MoE FFN (``models.moe``) and the MoE family
(granite-moe-1b-a400m, olmoe-1b-7b) against the JAX package, at smoke
size (4 experts, top-2), on the same numpy inputs and converted weights.

* ``apply_moe``: the dispatch buffer equal to the JAX one (read off the
  JAX function as it runs), out within ``ATTN_TOL``, ``aux_loss`` equal
  to its aux, at the JAX capacity factors None (dropless), an explicit
  0.0 (one slot per expert), and the config's 0.0 (dropless) and 1.25;
* ``live``: the port's output on the live rows equals the JAX function
  on those rows alone, and the dead rows are zero;
* model ``prefill``, ``prefill_chunk`` and ``decode_step`` logits within
  ``LOGIT_TOL``: at 1.25 on rows that are all live, at 0.0 on padded
  rows;
* greedy engine tokens equal to the JAX ``Engine(impl="ref")``'s: at 1.25
  on a wave with no padding and no dead slot; at 0.0 with mixed lengths,
  chunks, preemption and the prefix cache (at 1.25 a row's routing
  depends on the batch it runs in, so only such waves can agree);
* the JAX package's capacity counts prefill padding (its docstring's
  "dropless at inference" does not hold at the configs' 1.25), and the
  port's live rows do not move when the padding changes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.models import moe as jmoe
from repro.models.api import build_model as jbuild
from repro.serving import Engine as JEngine, Request as JRequest
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models import moe as tmoe
from repro_torch.serving import Engine, Request

from _torch_helpers import ATTN_TOL, LOGIT_TOL, close, t

NAMES = ["granite-moe-1b-a400m", "olmoe-1b-7b"]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(name, **kw):
    return get_smoke(name).replace(**kw), tget_smoke(name).replace(**kw)


def _moe_params(cfg, seed):
    p = jbuild(cfg).init_params(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(lambda a: np.array(a[0]),
                                  p["groups"]["0A"]["moe"])


class _Spy:
    """``jnp`` for ``repro.models.moe``, recording the first ``clip``
    argument of each call: the (E, C) dispatch buffer."""

    def __init__(self):
        self.clipped = []

    def __getattr__(self, name):
        return getattr(jnp, name)

    def clip(self, a, *args, **kw):
        self.clipped.append(np.asarray(a))
        return jnp.clip(a, *args, **kw)


def _jax_moe(monkeypatch, p, x, cfg, **kw):
    spy = _Spy()
    monkeypatch.setattr(jmoe, "jnp", spy)
    out, aux = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), cfg, **kw)
    monkeypatch.undo()
    return np.asarray(out), float(aux), spy.clipped[0]


# case: (the JAX config's knobs, the JAX call's, the port's moe_capacity).
# The port takes its factor from the config only, where 0 is dropless:
# JAX's explicit 0.0 (one slot per expert) is a factor that floors to one
# slot at these sizes.
CAPACITIES = {"none": ({}, dict(capacity_factor=None), 0.0),
              "explicit 0.0": ({}, dict(capacity_factor=0.0), 1e-3),
              "config 0.0": (dict(moe_capacity=0.0), {}, 0.0),
              "config 1.25": (dict(moe_capacity=1.25), {}, 1.25)}


def _case(name, case):
    """(JAX config, the JAX call's knobs, the port's config)."""
    jkw, call_kw, cap = CAPACITIES[case]
    return (get_smoke(name).replace(**jkw), call_kw,
            tget_smoke(name).replace(moe_capacity=cap))


@pytest.mark.parametrize("case", list(CAPACITIES))
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape", [(3, 7), (5,)])
def test_apply_moe_matches_reference(monkeypatch, name, case, shape):
    """Prefill-shaped (B, S, d) and decode-shaped (B, d) inputs; a tie in
    the router's top-k (two equal columns) goes to the lower expert on
    both sides."""
    jcfg, call_kw, tcfg = _case(name, case)
    p = _moe_params(jcfg, seed=1)
    p["router"][:, 3] = p["router"][:, 1]  # experts 1 and 3 tie
    rng = np.random.default_rng(2)
    x = rng.standard_normal(shape + (jcfg.d_model,)).astype(np.float32)
    ref, aux, disp = _jax_moe(monkeypatch, p, x, jcfg, **call_kw)
    tp = {k: t(v) for k, v in p.items()}
    got = tmoe.apply_moe(tp, t(x), tcfg)
    close(got, ref, ATTN_TOL)
    xf = t(x).reshape(-1, jcfg.d_model)
    probs, _, idx = tmoe.router(tp, xf, tcfg.top_k)
    assert abs(float(tmoe.aux_loss(probs, idx)) - aux) <= 1e-6
    C = tmoe.capacity(xf.shape[0], tcfg)
    _, ok, tdisp = tmoe.dispatch(idx, C, tcfg.n_experts)
    np.testing.assert_array_equal(tdisp.numpy(), disp)
    if case == "explicit 0.0":  # one slot per expert: choices drop
        assert C == 1 and not bool(ok.all())


def test_top_k_route_breaks_ties_toward_the_lower_expert():
    probs = t(np.array([[0.1, 0.3, 0.2, 0.3], [0.25] * 4], np.float32))
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    gates, idx = tmoe.top_k_route(probs, 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    close(gates, np.asarray(ref_v) / np.asarray(ref_v).sum(-1, keepdims=True),
          1e-7)


@pytest.mark.parametrize("case", ["none", "config 0.0", "config 1.25"])
@pytest.mark.parametrize("name", NAMES)
def test_apply_moe_live_equals_reference_on_the_live_rows(monkeypatch, name,
                                                          case):
    """A (3, 9) batch with a padded tail per row: the live tokens route
    as the JAX function routes them alone (their rank, the capacity from
    their count), the dead rows are zero."""
    jcfg, call_kw, tcfg = _case(name, case)
    p = _moe_params(jcfg, seed=3)
    rng = np.random.default_rng(4)
    B, S = 3, 9
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    lens = np.array([9, 4, 6])
    live = np.arange(S)[None] < lens[:, None]
    ref, aux, _ = _jax_moe(monkeypatch, p, x[live][None], jcfg, **call_kw)
    tp = {k: t(v) for k, v in p.items()}
    got = tmoe.apply_moe(tp, t(x), tcfg, live=t(live),
                         n_live=int(live.sum()))
    close(got.numpy()[live], ref[0], ATTN_TOL)
    assert not got.numpy()[~live].any()
    probs, _, idx = tmoe.router(tp, t(x).reshape(-1, jcfg.d_model),
                                tcfg.top_k)
    assert abs(float(tmoe.aux_loss(probs, idx, t(live))) - aux) <= 1e-6


# -- the model ----------------------------------------------------------------
def _models(name, seed=0, **kw):
    jcfg, tcfg = _configs(name, **kw)
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(seed))
    return jcfg, jm, jp, build_model(tcfg), params_from_numpy(_np(jp),
                                                              device="cpu")


def _pools(cfg, n_attn, B, pps):
    P = cfg.page_size
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = np.zeros((n_attn, B * pps + 1, P, cfg.n_kv_heads,
                     cfg.resolved_head_dim), np.float32)
    return tables, pool


def test_params_from_numpy_converts_moe_layers():
    jcfg, _, jp, tm, tp = _models("olmoe-1b-7b", seed=5)
    port = tm.init_params(torch.Generator().manual_seed(0))
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), tp)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    assert tp["layers"][1]["moe"]["wg"].shape == (4, jcfg.d_model, 64)
    np.testing.assert_array_equal(
        tp["layers"][1]["moe"]["wd"].numpy(),
        np.asarray(jp["groups"]["0A"]["moe"]["wd"][1]))


# (capacity, prompt lengths): 1.25 only where no token is padding
MODEL_CASES = {"1.25 equal rows": (1.25, [20, 20]),
               "0.0 padded rows": (0.0, [20, 11])}


@pytest.mark.parametrize("case", list(MODEL_CASES))
@pytest.mark.parametrize("name", NAMES)
def test_model_logits_match_reference(name, case):
    """``prefill`` then 4 teacher-forced decode steps, and
    ``prefill_chunk`` in chunks of 8, 8 and 4 over the same prompts (at
    1.25 every chunk is exactly as wide as its rows), on both of the
    port's paths."""
    cap, lens = MODEL_CASES[case]
    jcfg, jm, jp, tm, tp = _models(name, seed=6, moe_capacity=cap)
    rng = np.random.default_rng(6)
    B, S = len(lens), max(lens)
    lens = np.asarray(lens, np.int32)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    pps = -(-(S + 4) // jcfg.page_size)
    tables, pool = _pools(jcfg, tm.n_attn_layers, B, pps)
    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    jl, jst1 = jm.prefill(jp, jnp.asarray(tokens), jst,
                          lens=jnp.asarray(lens), impl="ref")
    ref, feed = [np.asarray(jl)], []
    for _ in range(4):
        feed.append(rng.integers(0, jcfg.vocab_size, B).astype(np.int32))
        jl, jst1 = jm.decode_step(jp, jnp.asarray(feed[-1]), jst1,
                                  impl="ref")
        ref.append(np.asarray(jl))
    # the chunks: each row's last chunk's logits
    chunk_ref, start = np.zeros_like(ref[0]), 0
    jst2 = dict(jst)
    for c in (8, 8, 4):
        ql = np.clip(lens - start, 0, c).astype(np.int32)
        jl, jst2 = jm.prefill_chunk(
            jp, jnp.asarray(tokens[:, start:start + c]), jst2,
            jnp.full((B,), start, jnp.int32), jnp.asarray(ql), impl="ref")
        ends = (start + ql == lens) & (ql > 0)
        chunk_ref[ends] = np.asarray(jl)[ends]
        start += c
    for impl in ("kernel", "ref"):
        st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
              "v_pages": t(pool)}
        logits, st1 = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                                 impl=impl)
        close(logits, ref[0], LOGIT_TOL)
        for i, tok in enumerate(feed):
            logits, st1 = tm.decode_step(tp, t(tok).long(), st1, impl=impl)
            close(logits, ref[i + 1], LOGIT_TOL)
        close(st1["k_pages"], jst1["k_pages"], LOGIT_TOL)
        st2, start, got = dict(st, k_pages=t(pool), v_pages=t(pool)), 0, None
        for c in (8, 8, 4):
            ql = np.clip(lens - start, 0, c).astype(np.int32)
            logits, st2 = tm.prefill_chunk(
                tp, t(tokens[:, start:start + c]).long(), st2,
                torch.full((B,), start, dtype=torch.int32), t(ql),
                impl=impl)
            got = logits if got is None else got
            ends = t((start + ql == lens) & (ql > 0))
            got[ends] = logits[ends]
            start += c
        close(got, chunk_ref, LOGIT_TOL)


# -- the engine ---------------------------------------------------------------
def _pair(name, prompts, max_new, cap, seed=7, **knobs):
    """Greedy tokens of the JAX reference engine and the port's on the
    same weights; steps and scheduler counters agree too."""
    jcfg, _, jp, _, tp = _models(name, seed=seed, moe_capacity=cap)
    tcfg = _configs(name, moe_capacity=cap)[1]
    jeng = JEngine(jcfg, jp, impl="ref", rng=jax.random.PRNGKey(7), **knobs)
    eng = Engine(tcfg, tp, device="cpu", **knobs)
    news = max_new if isinstance(max_new, list) else [max_new] * len(prompts)
    waves = prompts if isinstance(prompts[0][0], list) else [prompts]
    for wave in waves:
        out = []
        for e, R in ((jeng, JRequest), (eng, Request)):
            reqs = [R(prompt=list(p), max_new_tokens=n)
                    for p, n in zip(wave, news)]
            e.generate(reqs, max_steps=1000)
            out.append(reqs)
        assert all(r.done for r in out[1])
        assert [r.output for r in out[1]] == [r.output for r in out[0]]
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted
    assert eng.mgr.used_pages == jeng.mgr.used_pages
    return jeng, eng


@pytest.mark.parametrize("name", NAMES)
def test_engine_tokens_equal_reference_at_the_configs_capacity(name):
    """At 1.25: three prompts of 13 tokens on three slots, 6 new tokens
    each: no padding in the wave and no dead decode slot."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(1, 500, 13).tolist() for _ in range(3)]
    _pair(name, prompts, 6, 1.25, max_slots=3, max_seq_len=64)


PROMPTS = [[1, 2, 3, 4, 5, 6, 7] * 2, [11, 12, 13], [9] * 25, [4, 5]]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("knobs", [
    dict(max_slots=3),  # mixed lengths, dead decode slots
    dict(max_slots=4, prefill_chunk=8),
    dict(max_slots=4, prefill_chunk=13, pool_tokens=96),  # preemption
], ids=["monolithic", "chunked", "preemption"])
def test_engine_tokens_equal_reference_dropless(name, knobs):
    max_new = 20 if "pool_tokens" in knobs else 6
    jeng, _ = _pair(name, PROMPTS, max_new, 0.0, max_seq_len=64, **knobs)
    if "pool_tokens" in knobs:
        assert jeng.scheduler.preempted >= 1


@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_prefix_cache_tokens_equal_reference_dropless(chunk):
    """Wave 2 attaches to wave 1's cached head (3 pages) and runs only
    its tails, through the chunk path."""
    head = [9] * 24
    waves = [[head + [1, 2, 3]], [head + [5] * 9, head + [4, 5, 6, 7, 8]]]
    _, eng = _pair("granite-moe-1b-a400m", waves, 5, 0.0, max_slots=2,
                   max_seq_len=64, prefix_cache=True, prefill_chunk=chunk)
    assert eng.prefix_cache.hit_tokens >= 2 * len(head)


# -- fact: the JAX capacity counts padding ---------------------------------
def _padding_wave(pad_token, cap, port):
    """Prefill logits of a two-row wave, row 0 of 4 tokens padded with
    ``pad_token`` to row 1's 32, smoke granite-moe in f32 (PRNGKey(0))."""
    jcfg, jm, jp, tm, tp = _models("granite-moe-1b-a400m", seed=0,
                                   moe_capacity=cap)
    rng = np.random.default_rng(0)
    lens = np.array([4, 32], np.int32)
    tokens = rng.integers(1, jcfg.vocab_size, (2, 32)).astype(np.int32)
    tokens[0, 4:] = pad_token
    tables, pool = _pools(jcfg, tm.n_attn_layers, 2, 4)
    if port:
        st = {"pos": t(lens), "tables": t(tables), "k_pages": t(pool),
              "v_pages": t(pool)}
        logits, _ = tm.prefill(tp, t(tokens).long(), st, lens=t(lens))
        return logits.numpy()
    st = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
          "k_pages": jnp.asarray(pool), "v_pages": jnp.asarray(pool)}
    logits, _ = jm.prefill(jp, jnp.asarray(tokens), st,
                           lens=jnp.asarray(lens), impl="ref")
    return np.asarray(logits)


def test_jax_moe_capacity_counts_padding():
    """The JAX engine pads a wave with token 0 and its MoE ranks every
    row of the batch: changing only row 0's padding token (0 → 7) moves
    row 1's prefill logits at the configs' capacity factor 1.25
    (9.422e-2 at a logit scale of 1.196 with these inputs: 942x
    LOGIT_TOL), and not at all when dropless."""
    moved = np.abs(_padding_wave(0, 1.25, False)[1]
                   - _padding_wave(7, 1.25, False)[1]).max()
    print(f"JAX: row 1 moved by {moved:.3e} at 1.25")
    assert moved > 10 * LOGIT_TOL
    assert np.abs(_padding_wave(0, 0.0, False)[1]
                  - _padding_wave(7, 0.0, False)[1]).max() == 0.0


def test_port_moe_rows_do_not_see_the_padding():
    """The port routes only the live tokens: row 1 does not move when
    row 0's padding changes, at 1.25."""
    a, b = _padding_wave(0, 1.25, True), _padding_wave(7, 1.25, True)
    np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(a[0], b[0])
