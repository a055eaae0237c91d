"""PyTorch port: K1, K3 and K4 at head dim 256 (recurrentgemma-9b's
attention layers: 16 query heads over one kv head) against the JAX
package's Pallas kernels, from numpy inputs with a fixed seed.

The plain versions — what the wrappers run on CPU tensors, and what
``chip_smoke.py`` holds the CUDA kernels against on the card — at D 256
and G in {1, 16}, against the Pallas K1 and K3 in interpret mode (split
by split) and the Pallas ``_flex_kernel``, at ``ATTN_TOL``: K1 on dense
tables, on a ring table past the window and on int8 pools; K3 resuming
past cached pages, on pools of q's dtype and of int8; K4 under causal ∧
padding and window ∧ padding (the engine's masks for 'W' layers).  The
cases stay a few pages long, so that interpret mode stays quick.

On int8 pools K3's acc is bounded as ``tests/test_torch_int8.py`` bounds
it, ``ATTN_TOL · (1 + Σ p·|v|·kv_scale)``: an un-normalised sum over int8
V up to 127 · kv_scale, whose f32 rounding (the Pallas kernel's own
included) follows the magnitude the sum is taken over, not the element's.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core  # noqa: F401  (import order: core before kernels)
from repro.core import flex as jflex
from repro.kernels.flex_attention.ops import flex_attention as jflex_attention
from repro_torch.core import flex as tflex
from repro_torch.kernels import HEAD_DIMS, check_head_dim
from repro_torch.kernels.flex_attention.ops import (
    flex_attention as tflex_attention)
from repro_torch.kernels.paged_attention import paged_attention as tpa

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import (ATTN_TOL, close, paged_case,  # noqa: F401
                            pallas_interpret, t)

D = 256
GROUPS = [1, 16]


def rel_close(got, want, tol, mag):
    """``|got - want| <= tol * (1 + mag)``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.asarray(mag, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err = np.abs(got - want)
    assert (err <= tol * (1 + mag)).all(), float((err / (1 + mag)).max())


def test_every_route_takes_head_dim_256():
    assert D in HEAD_DIMS
    for kernel in ("decode kernel", "prefill kernel", "flex kernel"):
        check_head_dim(kernel, D)


def _decode_case(rng, G, kind):
    """(q, pools, tables, lens, kwargs) of a K1 case: dense tables, a ring
    table of 3 pages of 8 past a window of 16, or int8 pools."""
    kv_dtype = np.int8 if kind == "int8" else np.float32
    lens = [37, 9] if kind != "ring" else [45, 20]
    max_pages = 5 if kind != "ring" else 3
    q, kp, vp, tables, lens = paged_case(rng, 2, 1, G, D, 8, max_pages,
                                         lens, kv_dtype=kv_dtype)
    kw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=2)
    if kind == "ring":
        tables = rng.permutation(kp.shape[0])[:6].reshape(2, 3).astype(
            np.int32)
        kw.update(window=16)
    if kind == "int8":
        kw.update(kv_scale=0.05)
    return q, kp, vp, tables, lens, kw


@pytest.mark.parametrize("kind", ["dense", "ring", "int8"])
@pytest.mark.parametrize("G", GROUPS)
def test_decode_partials_match_pallas(pallas_interpret, G, kind):
    rng = np.random.default_rng(G + len(kind))
    q, kp, vp, tables, lens, kw = _decode_case(rng, G, kind)
    port = tpa.paged_attention_partials(t(q), t(kp), t(vp), t(tables),
                                        t(lens), **kw)
    pallas = jpa.paged_attention_partials(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), interpret=True, **kw)
    S = pallas[0].shape[2]
    assert port[2].shape == (2, 1, S, G, D)
    for s in range(S):  # split by split
        for a, b in zip(port, pallas):
            close(a[:, :, s], b[:, :, s], ATTN_TOL)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("G", GROUPS)
def test_prefill_partials_match_pallas(pallas_interpret, G, int8):
    rng = np.random.default_rng(50 + G + int8)
    kv_lens = np.array([30, 13], np.int32)
    q_start = np.array([19, 0], np.int32)
    C = int((kv_lens - q_start).max())
    _, kp, vp, tables, _ = paged_case(
        rng, 2, 1, 1, D, 8, 4, kv_lens,
        kv_dtype=np.int8 if int8 else np.float32)
    q = rng.standard_normal((2, C, G, D)).astype(np.float32)
    kw = dict(scale=D ** -0.5, pages_per_block=2, num_splits=2,
              q_block=max(1, 16 // G), kv_scale=0.05 if int8 else 0.0)
    arrs = (q, kp, vp, tables, kv_lens, q_start)
    port = tpa.paged_prefill_partials(*map(t, arrs), **kw)
    pallas = jpa.paged_prefill_partials(*map(jnp.asarray, arrs),
                                        interpret=True, **kw)
    assert port[0].shape == pallas[0].shape
    # acc's magnitude on int8 pools: the same sum over |v|
    mag = tpa.paged_prefill_partials(t(q), t(kp), t(np.abs(vp)),
                                     *map(t, arrs[3:]), **kw)[2]
    for s in range(pallas[0].shape[3]):  # split by split
        for i, (a, b) in enumerate(zip(port, pallas)):
            if int8 and i == 2:
                rel_close(a[:, :, :, s], b[:, :, :, s], ATTN_TOL,
                          mag[:, :, :, s])
            else:
                close(a[:, :, :, s], b[:, :, :, s], ATTN_TOL)


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("G", GROUPS)
def test_flex_masks_match_pallas(G, window):
    """Causal ∧ padding, or window ∧ padding."""
    rng = np.random.default_rng(300 + G + window)
    B, Q = 2, 40
    q = rng.standard_normal((B, G, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, 1, Q, D)).astype(np.float32)
    v = rng.standard_normal((B, 1, Q, D)).astype(np.float32)
    lens = np.array([Q, 23], np.int32)
    jm = jflex.and_masks(
        jflex.sliding_window_mask(window) if window else jflex.causal_mask,
        jflex.padding_mask(jnp.asarray(lens)))
    tm = tflex.and_masks(
        tflex.sliding_window_mask(window) if window else tflex.causal_mask,
        tflex.padding_mask(t(lens)))
    ref = jflex_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask_mod=jm, impl="pallas", q_block=16,
                          kv_block=16)
    port = tflex_attention(t(q), t(k), t(v), mask_mod=tm, q_block=16,
                           kv_block=16)
    close(port, ref, ATTN_TOL)
