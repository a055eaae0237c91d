"""PyTorch port: every mask and score mod of ``core.flex`` against the JAX
package.

- ``materialize`` and the BlockMasks (streaming builder, batched for mods
  that read tensors; the analytic windowed one) equal the JAX ones;
- K4 through the port's op (its plain version on the CPU) against the JAX
  ``flex_attention(impl="pallas")`` (the Pallas kernel in interpret
  mode) within ``ATTN_TOL``, with q/kv tiles of 64 and a ragged 48, GQA,
  Q = K = 160 (three ragged tiles), for each mod and the listed
  ``and``/``or``/``compose`` nests; the plain oracles (``impl="ref"``)
  agree as well.

The same factory builds each mod from either package's ``flex`` module,
from one set of numpy inputs made from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import flex as jflex
from repro.kernels.flex_attention.ops import flex_attention as jflex_attention
from repro.kernels.flex_attention.ref import flex_attention_ref as jref
from repro_torch.core import flex as tflex
from repro_torch.kernels.flex_attention.ops import (
    flex_attention as tflex_attention)
from repro_torch.kernels.flex_attention.ref import flex_attention_ref as tref

from _torch_helpers import ATTN_TOL, close, t

B, H, HKV, S, D = 2, 4, 2, 160, 32
_rng = np.random.default_rng(16)
LENS = np.array([S, 97], np.int32)
DOCS = np.repeat([0, 1, 2], [50, 60, 50])[None].repeat(B, 0).astype(
    np.int32)
DOCS_INTERLEAVED = _rng.integers(0, 3, (B, S)).astype(np.int32)
# three sequences packed into 160 slots, live up to 45, 70 and 20 tokens
SEQ_SLOTS = [50, 70, 40]
SID = np.repeat([0, 1, 2], SEQ_SLOTS).astype(np.int32)
POS = np.concatenate([np.arange(n) for n in SEQ_SLOTS]).astype(np.int32)
SEQ_LENS = np.array([45, 70, 20], np.int32)
SLOPES = (2.0 ** (-8.0 * (np.arange(H) + 1) / H)).astype(np.float32)


def mask_mods(F, A):
    """Mask mods by name, built from the flex module F over arrays A(x)."""
    pad = F.padding_mask(A(LENS))
    doc = F.document_mask(A(DOCS))
    prefix = F.prefix_lm_mask(40)
    window = F.sliding_window_mask(16)
    return {
        "full": F.full_mask,
        "causal": F.causal_mask,
        "window1": F.sliding_window_mask(1),
        "window16": window,
        "window100": F.sliding_window_mask(100),
        "padding": pad,
        "document": doc,
        "document_interleaved": F.document_mask(A(DOCS_INTERLEAVED)),
        "prefix_lm0": F.prefix_lm_mask(0),
        "prefix_lm40": prefix,
        "prefix_lmQ": F.prefix_lm_mask(S),
        "paged": F.paged_mask(A(SID), A(POS), A(SEQ_LENS)),
        "causal&padding": F.and_masks(F.causal_mask, pad),
        "window&padding": F.and_masks(window, pad),
        "causal&document": F.and_masks(F.causal_mask, doc),
        "prefix_lm|window": F.or_masks(prefix, window),
        "(prefix_lm|window)&padding": F.and_masks(
            F.or_masks(prefix, window), pad),
        "document|window": F.or_masks(doc, window),
        "(causal&document)|(window100&padding)": F.or_masks(
            F.and_masks(F.causal_mask, doc),
            F.and_masks(F.sliding_window_mask(100), pad)),
    }


def score_mods(F, A):
    alibi = F.alibi_score(A(SLOPES))
    cap = F.softcap_score(20.0)
    return {"identity": F.identity_score, "softcap": cap, "alibi": alibi,
            "softcap,alibi": F.compose_score(cap, alibi),
            "alibi,softcap": F.compose_score(alibi, cap)}


def _jmods():
    return mask_mods(jflex, jnp.asarray), score_mods(jflex, jnp.asarray)


def _tmods():
    return mask_mods(tflex, t), score_mods(tflex, t)


MASKS = list(mask_mods(tflex, t))
# (mask, score) pairs run through the kernels
PAIRS = ([(m, None) for m in MASKS]
         + [("causal", s) for s in score_mods(tflex, t)]
         + [("window&padding", "softcap"), ("causal&document", "alibi"),
            ("prefix_lm|window", "softcap,alibi")])


def _batched(mod):
    return isinstance(mod, (jflex.AuxMod, tflex.AuxMod))


@pytest.mark.parametrize("name", MASKS)
def test_materialize_equals_reference(name):
    jm, tm = _jmods()[0][name], _tmods()[0][name]
    np.testing.assert_array_equal(
        tflex.materialize(tm, B, H, S, S).expand(B, H, S, S).numpy(),
        np.broadcast_to(np.asarray(jflex.materialize(jm, B, H, S, S)),
                        (B, H, S, S)))


@pytest.mark.parametrize("tile", [64, 48])
@pytest.mark.parametrize("name", MASKS)
def test_block_mask_equals_reference(name, tile):
    jm, tm = _jmods()[0][name], _tmods()[0][name]
    Bm = B if _batched(tm) else None
    port = tflex.build_block_mask(tm, S, S, tile, tile, B=Bm)
    ref = jflex.build_block_mask(jm, S, S, tile, tile, B=Bm)
    assert (port.q_block, port.kv_block) == (ref.q_block, ref.kv_block)
    for a, b in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _qkv(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    v = rng.standard_normal((B, HKV, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("tile", [64, 48])
@pytest.mark.parametrize("mask,score", PAIRS)
def test_flex_mods_match_pallas(mask, score, tile):
    (jm, js), (tm, ts) = _jmods(), _tmods()
    q, k, v = _qkv(len(mask) + tile)
    kw = dict(q_block=tile, kv_block=tile)
    ref = jflex_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask_mod=jm[mask], score_mod=js.get(score),
                          impl="pallas", interpret=True, **kw)
    port = tflex_attention(t(q), t(k), t(v), mask_mod=tm[mask],
                           score_mod=ts.get(score), **kw)
    close(port, ref, ATTN_TOL)
    oracle = tflex_attention(t(q), t(k), t(v), mask_mod=tm[mask],
                             score_mod=ts.get(score), impl="ref")
    close(oracle, jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask_mod=jm[mask], score_mod=js.get(score)),
          ATTN_TOL)


@pytest.mark.parametrize("tile", [64, 48])
@pytest.mark.parametrize("mask,window", [("window16", 16),
                                         ("window&padding", 16),
                                         ("window100", 100)])
def test_windowed_block_mask_path_matches_pallas(mask, window, tile):
    """``window=`` selects the analytic windowed BlockMask, as the JAX op
    does on the prefill path (its full tiles skip the padding mask)."""
    (jm, _), (tm, _) = _jmods(), _tmods()
    q, k, v = _qkv(window + tile)
    kw = dict(q_block=tile, kv_block=tile, window=window)
    ref = jflex_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask_mod=jm[mask], impl="pallas", interpret=True,
                          **kw)
    port = tflex_attention(t(q), t(k), t(v), mask_mod=tm[mask], **kw)
    close(port, ref, ATTN_TOL)
    _same = tflex.causal_block_mask(S, S, tile, tile, window=window)
    _ref = jflex.causal_block_mask(S, S, tile, tile, window=window)
    for a, b in zip(_same[:3], _ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_score_mods_on_scores_equal_reference():
    """Each score mod on the same scores and indices, alone."""
    rng = np.random.default_rng(1)
    s = (rng.standard_normal((B, H, S, S)) * 30).astype(np.float32)
    b = np.arange(B)[:, None, None, None]
    h = np.arange(H)[None, :, None, None]
    q = np.arange(S)[None, None, :, None]
    k = np.arange(S)[None, None, None, :]
    js, ts = _jmods()[1], _tmods()[1]
    for name in js:
        want = js[name](jnp.asarray(s), *map(jnp.asarray, (b, h, q, k)))
        got = ts[name](t(s), *map(t, (b, h, q, k)))
        close(got, want, ATTN_TOL)
    assert torch.equal(ts["identity"](t(s), 0, 0, 0, 0), t(s))
