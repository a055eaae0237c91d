"""PyTorch port: the decode partition law and K1's plain version against
the JAX package — the Pallas decode kernel (interpret mode) and the
split-K oracle — split by split, at ``ATTN_TOL``."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import contracts as jcontracts
from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro_torch.kernels.paged_attention import contracts as tcontracts
from repro_torch.kernels.paged_attention import ops as tops
from repro_torch.kernels.paged_attention import paged_attention as tpa
from repro_torch.kernels.paged_attention import ref as tref

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import ATTN_TOL, close, paged_case, pallas_interpret, t  # noqa: F401

def test_decode_partition_equals_reference():
    for mp in range(1, 40):
        for ppb in (1, 2, 3, 4, 8, 50):
            for ns in (1, 2, 3, 5, 8, 64):
                assert (tcontracts.decode_partition(mp, ppb, ns)
                        == jcontracts.decode_partition(mp, ppb, ns))


def test_choose_decode_params_equals_reference():
    for mp in (1, 3, 7, 16, 32, 64, 257, 2048):
        for page in (8, 16, 64, 128):
            for hd in (64, 128, 256):
                for ppb, ns in ((None, None), (2, None), (None, 3),
                                (1, 1), (4, 2)):
                    ref = jops.choose_decode_params(
                        mp, page, hd, ppb, ns, backend="tpu")
                    port = tops.choose_decode_params(mp, page, hd, ppb, ns)
                    assert port == ref[:2]
                    # the combine rule: K2 ("pallas") iff split-K is active
                    assert (ref[2] == "pallas") == (port[1] > 1)
    # the full-width llama2-7b decode path (max_seq_len 2048, page 64):
    # four splits, so K2 runs
    assert tops.choose_decode_params(32, 64, 128) == (2, 4)


@pytest.mark.parametrize("window", [0, 20])
def test_blocked_tables_equal_reference(window):
    rng = np.random.default_rng(1)
    B, max_pages, page, num_pages = 4, 7, 8, 40
    tables = rng.integers(-1, num_pages, (B, max_pages)).astype(np.int32)
    lens = np.array([0, 9, 56, 30], np.int32)
    for ppb, ns in ((1, 1), (2, 3), (3, 2), (4, 8)):
        p, _, s, bps = jcontracts.decode_partition(max_pages, ppb, ns)
        kw = dict(num_pages=num_pages, page_size=page, window=window,
                  padded_pages=s * bps * p, pages_per_block=p)
        ref = jpa._blocked_tables(jnp.asarray(tables), jnp.asarray(lens),
                                  **kw)
        port = tpa._blocked_tables(t(tables), t(lens), **kw)
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# (G, ppb, splits, window, softcap, int8)
SWEEP = [(g, ppb, ns, 0, 0.0, False)
         for g in (1, 4) for ppb in (1, 2) for ns in (1, 2, 3)] + [
    (4, 2, 2, 20, 0.0, False),   # ring-slot sliding window
    (1, 1, 3, 0, 5.0, False),    # softcap
    (4, 2, 3, 0, 0.0, True),     # int8 pools x kv_scale
]


def _case(g, window, int8, seed):
    rng = np.random.default_rng(seed)
    B, Hkv, D, page = 3, 2, 16, 8
    if window:
        ring = -(-window // page) + 1
        q, kp, vp, _, _ = paged_case(rng, B, Hkv, g, D, page, ring, [1] * B)
        tables = rng.permutation(kp.shape[0])[:B * ring].reshape(
            B, ring).astype(np.int32)
        lens = np.array([5, 23, 61], np.int32)  # 61 wraps the ring
        return q, kp, vp, tables, lens
    lens = [50, 13, 1]
    return paged_case(rng, B, Hkv, g, D, page, 7, lens,
                      kv_dtype=np.int8 if int8 else np.float32)


@pytest.mark.parametrize("g,ppb,ns,window,softcap,int8", SWEEP)
def test_decode_partials_match_pallas_and_oracle(pallas_interpret, g, ppb,
                                                 ns, window, softcap, int8):
    q, kp, vp, tables, lens = _case(g, window, int8, seed=g * 10 + ns)
    B, Hkv, G, D = q.shape
    kw = dict(scale=D ** -0.5, window=window, softcap=softcap,
              kv_scale=0.05 if int8 else 0.0)
    part = dict(pages_per_block=ppb, num_splits=ns)
    port = tpa.paged_attention_partials(t(q), t(kp), t(vp), t(tables),
                                        t(lens), **kw, **part)
    pallas = jpa.paged_attention_partials(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), **kw, **part)
    qh = q.reshape(B, Hkv * G, D)
    oracle = jref.paged_attention_partials_ref(
        jnp.asarray(qh), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), **kw, **part)
    port_oracle = tref.paged_attention_partials_ref(
        t(qh), t(kp), t(vp), t(tables), t(lens), **kw, **part)
    S = pallas[0].shape[2]
    assert port[0].shape == (B, Hkv, S, G) and port[2].shape[-1] == D
    for s in range(S):  # split by split
        for a, b, c, d in zip(port, pallas, oracle, port_oracle):
            close(a[:, :, s], b[:, :, s], ATTN_TOL)
            close(a[:, :, s], c[:, :, s], ATTN_TOL)
            close(d[:, :, s], c[:, :, s], ATTN_TOL)


def test_plain_versions_chosen_only_for_cpu_tensors():
    """On the CPU the wrappers run the plain versions and count nothing."""
    q, kp, vp, tables, lens = _case(1, 0, False, seed=0)
    before = tpa.paged_attention_partials.launches
    tpa.paged_attention_partials(t(q), t(kp), t(vp), t(tables), t(lens),
                                 scale=0.25)
    assert tpa.paged_attention_partials.launches == before
    meta = torch.empty(q.shape, device="meta")
    with pytest.raises(Exception, match="device"):
        tpa.paged_attention_partials(meta, t(kp), t(vp), t(tables), t(lens),
                                     scale=0.25)
