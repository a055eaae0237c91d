"""PyTorch port: the split-TF32 ("3xTF32") arithmetic of K3's and K4's
f32 tensor-core routes, modelled on the CPU.

The f32 kernels (``csrc/flash_tf32.cuh``) split every operand x into two
TF32 words, hi = rna(x) and lo = rna(x - hi) (``cvt.rna.tf32.f32``: to
nearest, ties away from zero, 10 explicit mantissa bits), and evaluate
each product as lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b): q·K with Q and K
split, p·V with the probabilities and V split.  ``kernels.tf32`` rounds
exactly as that instruction does, and the plain K3 and K4 versions with
``tf32_terms`` evaluate q·K and p·V with those products.

The tolerance is the port's f32 contract, the one chip_smoke holds the
kernels to: ``|a - b| <= 2e-5 * (1 + |b|)`` against the unrounded f32
plain version.  Three terms leave a residual below 2^-22 of each operand
(about 2^-21 of each product), far inside it, while one TF32 term (11
significant bits) leaves errors of order 2^-11 in every score, beyond it:
which is why the kernels pay for three products.  The shapes are the main
paths' longest, cut in heads: K3 resuming at 1536 over a full 32-page
table (2048 keys, the longest un-normalised sums), K4 at Q = K = 2048
under causal ∧ padding.  Each case also prints how far each side is from
the plain version evaluated in f64.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import flex
from repro_torch.kernels.flex_attention import flex_attention as fa
from repro_torch.kernels.paged_attention import paged_attention as pa

F32_TOL = 2e-5  # chip_smoke's f32 tolerance, relative: tol * (1 + |b|)


def rel_err(got, want):
    """max |a - b| / (1 + |b|): within F32_TOL passes the card's check."""
    got, want = got.double(), want.double()
    assert got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    return float(((got - want).abs() / (1 + want.abs())).max())


def f64_dist(x, exact):
    return float((x.double() - exact).abs().max())


# -- the rounding ------------------------------------------------------------
def test_tf32_rounds_to_nearest_ties_away_with_13_low_bits_zero():
    u = 2.0 ** -10  # one TF32 ulp at 1
    x = torch.tensor([1.0, 1 + u / 2, 1 + u / 4, 1 + 3 * u / 4, -(1 + u / 2),
                      3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1 + u, 1.0, 1 + u, -(1 + u), 3.0, 0.0],
                        dtype=torch.float32)
    got = kernels.tf32(x)
    assert torch.equal(got, want)
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 1e3)
    bits = kernels.tf32(y).view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    # round to nearest: at most half an ulp of 2^-10 relative
    assert bool(((kernels.tf32(y) - y).abs()
                 <= 2.0 ** -11 * y.abs() + 1e-30).all())


def test_tf32_product_three_terms_leave_about_21_bits():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 64)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    e3 = float(((kernels.tf32_product(torch.matmul, a, b, 3) - exact).abs()
                / scale).max())
    e1 = float(((kernels.tf32_product(torch.matmul, a, b, 1) - exact).abs()
                / scale).max())
    assert e3 < 2.0 ** -19, e3
    assert e1 > 2.0 ** -14, e1
    assert torch.equal(kernels.tf32_product(torch.matmul, a, b), a @ b)


# -- K3 and K4 with the products split ---------------------------------------
def k3_full_table_inputs(H):
    """A 512-token chunk resuming at 1536 over a full 32-page table (kv
    2048) and a 300-token chunk at 1000; D 128, pages of 64."""
    rng = np.random.default_rng(15)
    D, P, max_pages = 128, 64, 32
    q_start, q_lens = [1536, 1000], [512, 300]
    kv_lens = [s + n for s, n in zip(q_start, q_lens)]
    B, C = len(q_start), max(q_lens)
    num_pages = B * max_pages + 3

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q = randn(B, C, H, D)
    kp, vp = randn(num_pages, P, H, D), randn(num_pages, P, H, D)
    perm = rng.permutation(num_pages)
    tables = np.full((B, max_pages), -1, np.int32)
    used = 0
    for b in range(B):
        n = -(-kv_lens[b] // P)
        tables[b, :n] = perm[used:used + n]
        used += n
    return (q, kp, vp, torch.from_numpy(tables),
            torch.tensor(kv_lens, dtype=torch.int32),
            torch.tensor(q_start, dtype=torch.int32))


@pytest.mark.parametrize("splits", [1, 2])
def test_prefill_plain_with_three_tf32_terms_within_f32_tolerance(splits):
    """K3's longest sums at 2 heads: the split-TF32 partials are within the
    f32 tolerance of the f32 ones; one TF32 term is not."""
    args = k3_full_table_inputs(H=2)
    kw = dict(scale=128 ** -0.5, softcap=0.0, kv_scale=0.0,
              pages_per_block=2, num_splits=splits, q_block=128)
    want = pa._paged_prefill_partials_plain(*args, **kw)
    exact = pa._paged_prefill_partials_plain(
        *(x.double() for x in args[:3]), *args[3:], **kw)
    errs = {}
    for terms in (3, 1):
        got = pa._paged_prefill_partials_plain(*args, tf32_terms=terms, **kw)
        errs[terms] = max(rel_err(g, w) for g, w in zip(got, want))
        for part, g, w, x in zip("m l acc".split(), got, want, exact):
            print(f"K3 S{splits} {part}: {terms} tf32 term(s) "
                  f"max|err| vs f64 {f64_dist(g, x):.3e}, f32 plain "
                  f"{f64_dist(w, x):.3e}")
    assert errs[3] <= F32_TOL, errs
    assert errs[1] > F32_TOL, errs


def test_flex_plain_with_three_tf32_terms_within_f32_tolerance():
    """K4's main path at its longest (causal & padding, 128 x 128 tiles, D
    128, Q = K = 2048) at 2 heads: the split-TF32 output is within the f32
    tolerance of the f32 one; one TF32 term is not."""
    rng = np.random.default_rng(16)
    B, H, Q, D = 2, 2, 2048, 128

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = randn(B, H, Q, D), randn(B, H, Q, D), randn(B, H, Q, D)
    lens = torch.tensor([Q, 1500], dtype=torch.int32)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(lens))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=B)
    kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
    want = fa._flex_attention_plain(q, k, v, bm, **kw)
    # f64 evaluation (the plain K4 computes in f32): dense causal & padding
    qi, ki = torch.arange(Q)[:, None], torch.arange(Q)[None, :]
    live = (ki <= qi)[None] & (ki[None] < lens[:, None, None])  # (B, Q, K)
    s = (q.double() * D ** -0.5) @ k.double().transpose(-1, -2)
    s = s.masked_fill(~live[:, None], float("-inf"))
    exact = torch.softmax(s, dim=-1) @ v.double()
    errs = {}
    for terms in (3, 1):
        got = fa._flex_attention_plain(q, k, v, bm, tf32_terms=terms, **kw)
        errs[terms] = rel_err(got, want)
        print(f"K4: {terms} tf32 term(s) max|err| vs f64 "
              f"{f64_dist(got, exact):.3e}, f32 plain "
              f"{f64_dist(want, exact):.3e}")
    assert errs[3] <= F32_TOL, errs
    assert errs[1] > F32_TOL, errs
