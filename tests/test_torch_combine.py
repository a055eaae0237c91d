"""PyTorch port: K2's plain version against the JAX Pallas combine kernel
(interpret mode) and the combine oracle, all-dead slots included, and the
public ``paged_attention`` op end to end, at ``ATTN_TOL``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import paged_attention as tpa
from repro_torch.kernels.paged_attention import ref as tref

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import ATTN_TOL, close, paged_case, pallas_interpret, t  # noqa: F401


def _partials(rng, B=3, Hkv=2, S=3, G=4, D=16, dead=()):
    m = rng.standard_normal((B, Hkv, S, G)).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, (B, Hkv, S, G)).astype(np.float32)
    acc = rng.standard_normal((B, Hkv, S, G, D)).astype(np.float32)
    for b, h, s in dead:  # empty splits: the kernel's (NEG_INF, 0, 0)
        m[b, h, s], l[b, h, s], acc[b, h, s] = -1e30, 0.0, 0.0
    return m, l, acc


@pytest.mark.parametrize("S,G", [(1, 1), (3, 4), (4, 1)])
def test_combine_matches_pallas_and_oracle(pallas_interpret, S, G):
    rng = np.random.default_rng(S * 7 + G)
    dead = [(0, 0, 0)] + [(1, 1, s) for s in range(S)]  # (1,1): all dead
    m, l, acc = _partials(rng, S=S, G=G, dead=dead)
    port = tpa.combine_partials_kernel(t(m), t(l), t(acc))
    pallas = jpa.combine_partials_pallas(jnp.asarray(m), jnp.asarray(l),
                                         jnp.asarray(acc))
    oracle = jref.combine_partials_ref(jnp.asarray(m), jnp.asarray(l),
                                       jnp.asarray(acc))
    B, Hkv = m.shape[:2]
    close(port, pallas, ATTN_TOL)
    close(port.reshape(B, Hkv * G, -1), oracle, ATTN_TOL)
    close(tref.combine_partials_ref(t(m), t(l), t(acc)), oracle, ATTN_TOL)
    assert torch.equal(port[1, 1], torch.zeros_like(port[1, 1]))  # exact 0
    # K2 when S > 1, the one-split epilogue otherwise: one function
    for fn in (tpa._combine_partials_plain, tpa.combine_partials):
        close(fn(t(m), t(l), t(acc)), pallas, ATTN_TOL)


@pytest.mark.parametrize("ppb,ns,window", [(2, 2, 0), (1, 3, 0), (2, 2, 20),
                                           (None, None, 0)])
def test_paged_attention_op_matches_reference(pallas_interpret, ppb, ns,
                                              window):
    rng = np.random.default_rng(5)
    B, Hkv, G, D, page = 3, 2, 2, 16, 8
    if window:
        ring = -(-window // page) + 1
        q, kp, vp, _, _ = paged_case(rng, B, Hkv, G, D, page, ring, [1] * B)
        tables = rng.permutation(kp.shape[0])[:B * ring].reshape(
            B, ring).astype(np.int32)
        lens = np.array([3, 27, 70], np.int32)
    else:
        q, kp, vp, tables, lens = paged_case(rng, B, Hkv, G, D, page, 7,
                                             [41, 8, 56])
    qh = q.reshape(B, Hkv * G, D)
    kw = dict(window=window, pages_per_block=ppb, num_splits=ns)
    port = tops.paged_attention(t(qh), t(kp), t(vp), t(tables), t(lens),
                                **kw)
    ref = jops.paged_attention(
        jnp.asarray(qh), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), impl="pallas",
        backend="tpu", **kw)
    oracle = jref.paged_attention_ref(
        jnp.asarray(qh), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), window=window)
    close(port, ref, ATTN_TOL)
    close(port, oracle, ATTN_TOL)
    port_ref = tops.paged_attention(t(qh), t(kp), t(vp), t(tables), t(lens),
                                    window=window, impl="ref")
    close(port_ref, oracle, ATTN_TOL)
