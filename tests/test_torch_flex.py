"""PyTorch port: BlockMask compilation and K4's plain version against the
JAX package's flex attention (Pallas kernel in interpret mode), for the
mask the prefill path composes — causal ∧ padding(lens) — with ragged
tiles and GQA, at ``ATTN_TOL``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import flex as jflex
from repro.kernels.flex_attention.ops import flex_attention as jflex_attention
from repro_torch.core import flex as tflex
from repro_torch.errors import UnsupportedFeature
from repro_torch.kernels.flex_attention.ops import (
    flex_attention as tflex_attention)

from _torch_helpers import ATTN_TOL, close, t


def _same_mask(port, ref):
    assert (port.q_block, port.kv_block) == (ref.q_block, ref.kv_block)
    for a, b in zip(port[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("Q,K,qb,kb", [(40, 40, 16, 16), (33, 50, 8, 16),
                                       (128, 128, 128, 128)])
def test_build_block_mask_batched_padding_equals_reference(Q, K, qb, kb):
    lens = np.array([K, 5, 17], np.int32)
    jm = jflex.and_masks(jflex.causal_mask, jflex.padding_mask(
        jnp.asarray(lens)))
    tm = tflex.and_masks(tflex.causal_mask, tflex.padding_mask(t(lens)))
    _same_mask(tflex.build_block_mask(tm, Q, K, qb, kb, B=3),
               jflex.build_block_mask(jm, Q, K, qb, kb, B=3))
    _same_mask(tflex.build_block_mask(tflex.causal_mask, Q, K, qb, kb),
               jflex.build_block_mask(jflex.causal_mask, Q, K, qb, kb))


@pytest.mark.parametrize("window", [0, 24])
def test_causal_block_mask_equals_reference(window):
    for Q, K, qb, kb in ((40, 40, 16, 16), (100, 100, 32, 16),
                         (77, 77, 77, 77)):
        _same_mask(tflex.causal_block_mask(Q, K, qb, kb, window=window),
                   jflex.causal_block_mask(Q, K, qb, kb, window=window))


# (B, H, Hkv, Q, D, q_block, kv_block): Q not a multiple of the tiles
CASES = [(2, 4, 2, 40, 16, 16, 16),    # GQA, 3 ragged q tiles
         (3, 2, 2, 37, 8, 8, 16),      # unequal tiles
         (2, 2, 1, 150, 16, 128, 128)]  # the op's default 128 tiles


@pytest.mark.parametrize("B,H,Hkv,Q,D,qb,kb", CASES)
def test_flex_causal_padding_matches_pallas(B, H, Hkv, Q, D, qb, kb):
    rng = np.random.default_rng(Q)
    q = rng.standard_normal((B, H, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Q, D)).astype(np.float32)
    lens = rng.integers(1, Q + 1, B).astype(np.int32)
    lens[0] = Q
    jm = jflex.and_masks(jflex.causal_mask,
                         jflex.padding_mask(jnp.asarray(lens)))
    tm = tflex.and_masks(tflex.causal_mask, tflex.padding_mask(t(lens)))
    ref = jflex_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask_mod=jm, impl="pallas", q_block=qb,
                          kv_block=kb)
    port = tflex_attention(t(q), t(k), t(v), mask_mod=tm, q_block=qb,
                           kv_block=kb)
    close(port, ref, ATTN_TOL)
    oracle = tflex_attention(t(q), t(k), t(v), mask_mod=tm, impl="ref")
    close(oracle, ref, ATTN_TOL)


def test_flex_kernel_rejects_mods_it_does_not_compile():
    q = torch.zeros((1, 2, 8, 16))
    window = tflex.sliding_window_mask(4)
    with pytest.raises(UnsupportedFeature):
        tflex_attention(q, q, q, mask_mod=tflex.and_masks(window,
                                                          tflex.causal_mask))
    with pytest.raises(UnsupportedFeature):
        tflex_attention(q, q, q, score_mod=tflex.softcap_score(5.0))
