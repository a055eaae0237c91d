"""PyTorch port: the training forward of every family against the JAX
package, on the CPU at smoke size, from the JAX weights and numpy batches.

- (a) ``loss_fn``: ce and aux within ``LOSS_TOL`` relative, and every
  gradient (through ``params_to_numpy``, in the JAX tree) within
  ``GRAD_TOL · (1 + |g|)`` of ``jax.value_and_grad``, for each family:
  dense llama2-7b (``A``), its ``W`` variant, recurrentgemma (``RW``),
  granite-moe at capacity 1.25 (tokens dropped), the cross-attention VLM
  (``CA``), whisper (encoder-decoder) and xLSTM (``MS``); also a masked
  loss, ``remat="full"`` and a pattern with trailing layers.
- (b) ``_chunked_attention`` with tiles of 8 and 16 against the JAX
  ``_chunked_attention`` at the same tiles (causal, window, padding, GQA,
  softcap) at ``ATTN_TOL``, and the ``"chunked"`` loss and gradients
  against ``"ref"``.
- (c) ``impl="kernel"`` under autograd raises ``UnsupportedFeature``
  (K4 has no backward); under ``torch.no_grad()`` it runs.
- (d) the paper's §IV-B3 check on briefly trained weights: the
  teacher-forced NLL equals the prefill + paged-decode NLL within
  ``NLL_TOL``, and the JAX forward on the same weights
  (``params_to_numpy``) gives the same NLL; a paged decode that drops
  one page of keys moves the NLL by more than ``NLL_TOL``.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.core import flex as jflex
from repro.core.attention import _chunked_attention as jchunked
from repro.data import synthetic_batches as jbatches
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core import attention as tcore_attn
from repro_torch.core import flex as tflex
from repro_torch.core.attention import _chunked_attention as tchunked
from repro_torch.data import synthetic_batches
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.models import (build_model, params_from_numpy,
                                params_to_numpy)
from repro_torch.training import train_loop
from repro_torch.training.evaluate import paged_decode_nll, teacher_forced_nll
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

from _torch_helpers import ATTN_TOL, close, t

LOSS_TOL = 1e-5  # relative, ce and aux
GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
NLL_TOL = 1e-4  # teacher-forced against paged decode, f32

FAMILIES = {
    "dense": ("llama2-7b", {}),
    "window": ("llama2-7b", dict(layer_pattern="W", window=8)),
    "rglru": ("recurrentgemma-9b", {}),
    "moe": ("granite-moe-1b-a400m", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
    "encdec": ("whisper-medium", {}),
    "xlstm": ("xlstm-350m", {}),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _models(name, **kw):
    jcfg, tcfg = get_smoke(name).replace(**kw), tget_smoke(name).replace(**kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    return jcfg, tcfg, jm, tm, jp, params_from_numpy(_np(jp), "cpu")


def _batch(cfg, B=2, S=32, seed=1):
    return next(jbatches(B, S, cfg.vocab_size, seed=seed, cfg=cfg))


def _port_grads(tm, params, batch, impl="ref"):
    """(loss, parts, grads) of the port by autograd."""
    p = tree_map(lambda x: x.detach().requires_grad_(), params)
    loss, parts = tm.loss_fn(p, {k: t(v) for k, v in batch.items()},
                             impl=impl)
    leaves = tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    parts = {k: v.detach() for k, v in parts.items()}
    return loss.detach(), parts, tree_unflatten(p, [
        torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)])


def _jax_grads(jm, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True))(jp)
    return loss, parts, _np(g)


def _check_grads(want, got):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat_w] == [
        jax.tree_util.keystr(p) for p, _ in flat_g]
    for (path, w), (_, g) in zip(flat_w, flat_g):
        err = np.abs(np.asarray(g, np.float64) - w) / (1 + np.abs(w))
        assert float(err.max()) <= GRAD_TOL, (jax.tree_util.keystr(path),
                                              float(err.max()))


def _check_loss(jl, jparts, tl, tparts):
    for want, got in ((jl, tl), (jparts["ce"], tparts["ce"]),
                      (jparts["aux"], tparts["aux"])):
        want, got = float(want), float(got)
        assert abs(got - want) <= LOSS_TOL * abs(want), (got, want)


# -- (a) loss and gradients of every family -----------------------------------
@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    name, kw = FAMILIES[family]
    jcfg, tcfg, jm, tm, jp, tp = _models(name, **kw)
    batch = _batch(jcfg)
    jl, jparts, jg = _jax_grads(jm, jp, batch)
    tl, tparts, tg = _port_grads(tm, tp, batch)
    _check_loss(jl, jparts, tl, tparts)
    if family == "moe":
        assert float(tparts["aux"]) > 0
    _check_grads(jg, params_to_numpy(tg, tcfg))


@pytest.mark.parametrize("case", ["mask", "remat", "trailing"])
def test_loss_variants_match_jax(case):
    """A masked loss; ``remat="full"`` (each pattern unit recomputed in
    the backward); 5 layers of ``RRW`` (one scanned unit and two trailing
    ``R`` layers in the JAX tree's ``rem``)."""
    kw = {"remat": dict(remat="full"),
          "trailing": dict(n_layers=5, layer_pattern="RRW")}.get(case, {})
    name = "recurrentgemma-9b" if case == "trailing" else "llama2-7b"
    jcfg, tcfg, jm, tm, jp, tp = _models(name, **kw)
    batch = _batch(jcfg)
    if case == "mask":
        batch["mask"] = (np.random.default_rng(3).random((2, 32))
                         < 0.6).astype(np.float32)
    jl, jparts, jg = _jax_grads(jm, jp, batch)
    tl, tparts, tg = _port_grads(tm, tp, batch)
    _check_loss(jl, jparts, tl, tparts)
    _check_grads(jg, params_to_numpy(tg, tcfg))


@pytest.mark.parametrize("family", ["rglru", "moe", "encdec"])
def test_params_to_numpy_inverts_params_from_numpy(family):
    name, kw = FAMILIES[family]
    if family == "rglru":
        kw = dict(n_layers=5, layer_pattern="RRW")
    jcfg, tcfg, jm, tm, jp, tp = _models(name, **kw)
    back = params_to_numpy(tp, tcfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, _np(jp), back)


# -- (b) the chunked online softmax -------------------------------------------
def _mods(kind, lens):
    """(JAX mask, port mask, JAX score, port score) of a case."""
    if kind == "window":
        return (jflex.sliding_window_mask(5), tflex.sliding_window_mask(5),
                None, None)
    if kind == "padding":
        return (jflex.and_masks(jflex.causal_mask, jflex.padding_mask(
                    jnp.asarray(lens))),
                tflex.and_masks(tflex.causal_mask, tflex.padding_mask(
                    t(lens))), None, None)
    if kind == "softcap":
        return (jflex.causal_mask, tflex.causal_mask,
                jflex.softcap_score(2.0), tflex.softcap_score(2.0))
    return jflex.causal_mask, tflex.causal_mask, None, None


@pytest.mark.parametrize("kind", ["causal", "window", "padding", "softcap"])
@pytest.mark.parametrize("Q,Hkv,G,qc,kc", [(37, 2, 1, 8, 16),
                                           (40, 1, 3, 16, 8),
                                           (16, 2, 2, 8, 8)])
def test_chunked_attention_matches_jax(kind, Q, Hkv, G, qc, kc):
    """Several q and kv tiles, a ragged last tile (37), GQA: the same
    online softmax as the JAX function at the same tiles."""
    B, D = 2, 16
    rng = np.random.default_rng(Q + G)
    q = rng.standard_normal((B, Hkv * G, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    lens = np.array([Q, Q // 2 + 1], np.int32)
    jm, tm, js, ts = _mods(kind, lens)
    want = jchunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm, js,
                    q_chunk=qc, kv_chunk=kc)
    got = tchunked(t(q), t(k), t(v), tm, ts, q_chunk=qc, kv_chunk=kc)
    close(got, want, ATTN_TOL)


@pytest.mark.parametrize("family", ["dense", "window", "encdec"])
def test_chunked_loss_and_grads_match_ref(family):
    """Tiles of 512 × 1024 over 32 tokens are one tile: the port's
    ``"chunked"`` loss and gradients equal its dense ``"ref"`` ones (and
    the JAX ``"chunked"`` loss)."""
    name, kw = FAMILIES[family]
    jcfg, tcfg, jm, tm, jp, tp = _models(name, **kw)
    batch = _batch(jcfg)
    rl, _, rg = _port_grads(tm, tp, batch, "ref")
    cl, _, cg = _port_grads(tm, tp, batch, "chunked")
    jl, _ = jm.loss_fn(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       impl="chunked")
    assert abs(float(cl) - float(rl)) <= LOSS_TOL * abs(float(rl))
    assert abs(float(cl) - float(jl)) <= LOSS_TOL * abs(float(jl))
    for a, b in zip(tree_leaves(cg), tree_leaves(rg)):
        close(a, b, GRAD_TOL)


# -- (c) the kernel under autograd ----------------------------------------------
@pytest.mark.parametrize("family", ["dense", "encdec"])
def test_kernel_impl_under_grad_raises(family):
    name, kw = FAMILIES[family]
    jcfg, tcfg, jm, tm, jp, tp = _models(name, **kw)
    batch = {k: t(v) for k, v in _batch(jcfg).items()}
    p = tree_map(lambda x: x.detach().requires_grad_(), tp)
    with pytest.raises(UnsupportedFeature, match="no backward"):
        tm.loss_fn(p, batch, impl="kernel")
    with torch.no_grad():  # forward only: K4's plain version on the CPU
        got, _ = tm.loss_fn(p, batch, impl="kernel")
    want, _ = tm.loss_fn(tp, batch, impl="ref")
    assert abs(float(got) - float(want)) <= LOSS_TOL * float(want)


def test_forward_impl_is_checked():
    _, _, _, tm, _, tp = _models("llama2-7b")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(EngineConfigError, match="chunked"):
        tm.forward(tp, tokens, impl="pallas")


# -- (d) perplexity equivalence -------------------------------------------------
@pytest.mark.parametrize("family", ["dense", "window", "rglru"])
def test_teacher_forced_nll_equals_paged_decode_nll(family):
    name, kw = FAMILIES[family]
    cfg = tget_smoke(name).replace(**kw)
    model = build_model(cfg)
    state, _ = train_loop(model, synthetic_batches(4, 32, cfg.vocab_size),
                          steps=6, lr=2e-3, log_fn=lambda s: None,
                          device="cpu")
    params = state.params
    toks = t(next(synthetic_batches(2, 24, cfg.vocab_size,
                                    seed=9))["inputs"]).long()
    forced = float(teacher_forced_nll(model, params, toks))
    paged = float(paged_decode_nll(model, params, toks, impl="kernel"))
    plain = float(paged_decode_nll(model, params, toks, impl="ref"))
    assert abs(forced - paged) <= NLL_TOL and abs(forced - plain) <= NLL_TOL
    # the JAX forward scores the port's trained weights the same
    jm = jbuild(get_smoke(name).replace(**kw))
    logits = jm.forward(jax.tree_util.tree_map(
        jnp.asarray, params_to_numpy(params, cfg)), jnp.asarray(toks.numpy()))
    lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    gold = jnp.take_along_axis(lp, jnp.asarray(toks[:, 1:, None].numpy()), 2)
    assert abs(float(-jnp.mean(gold)) - forced) <= NLL_TOL


@contextlib.contextmanager
def _dropped_first_page():
    """Paged decode attention that skips each row's first page once the
    row has passed it (its table rolled by one page, its length less one
    page): a kernel that lost one page of keys."""
    real = tcore_attn.decode_attention

    def faulty(q, k_pages, v_pages, tables, lens, **kw):
        P = k_pages.shape[1]
        past = lens > P
        tables = torch.where(past[:, None], tables.roll(-1, dims=1), tables)
        lens = torch.where(past, lens - P, lens)
        return real(q, k_pages, v_pages, tables, lens, **kw)

    tcore_attn.decode_attention = faulty
    try:
        yield
    finally:
        tcore_attn.decode_attention = real


def test_nll_check_sees_a_dropped_page():
    """The check above can fail: one page of keys lost in paged decode
    moves the NLL by more than ``NLL_TOL`` on the same trained weights."""
    cfg = tget_smoke("llama2-7b")
    model = build_model(cfg)
    state, _ = train_loop(model, synthetic_batches(4, 32, cfg.vocab_size),
                          steps=6, lr=2e-3, log_fn=lambda s: None,
                          device="cpu")
    toks = t(next(synthetic_batches(2, 24, cfg.vocab_size,
                                    seed=9))["inputs"]).long()
    good = float(paged_decode_nll(model, state.params, toks, impl="kernel"))
    with _dropped_first_page():
        bad = float(paged_decode_nll(model, state.params, toks,
                                     impl="kernel"))
    assert abs(bad - good) > NLL_TOL, (good, bad)
