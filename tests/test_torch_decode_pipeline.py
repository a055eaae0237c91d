"""PyTorch port: K1's pipelined design and the decode op, against the JAX
package, from numpy inputs with a fixed seed.

- (a) K1 sums in another order than the plain version: each of its W
  consumer warps owns a fixed share of every tile of kT tokens (rows
  [w·kT/W, (w+1)·kT/W)), keeps its own online softmax, updated once per
  tile, and the warps' partials are merged with K2's formula at the end.
  A plain model of that order, at 2048 keys in one split and in four,
  equals K1's plain version and the Pallas ``_decode_kernel`` (interpret
  mode) within ``ATTN_TOL`` in f32.
- (b) The decode op's C call at every split count, one included: K1's
  ``m``, ``l`` and ``acc`` as views of one buffer, with the shapes, dtype
  and contiguity that K2's wrapper checks, then the output, which K2
  writes; K1 alone (the partials) takes the same buffer and no output.
- (c) ``paged_attention_kernel`` (the decode op) on CPU tensors equals the
  JAX ``paged_attention_kernel`` at the engine's decode partition (2 pages
  per block, 4 splits, page 64, D 128; heads cut to 4) within ``ATTN_TOL``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_attention import paged_attention as tpa
from repro_torch.kernels.paged_attention.contracts import decode_partition

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import ATTN_TOL, close, paged_case, pallas_interpret, t  # noqa: F401

NEG_INF = tpa.NEG_INF


def warp_order_partials(q, k_pages, v_pages, tables, lens, *, scale,
                        pages_per_block, num_splits, warps, tile):
    """K1's order of summation in plain PyTorch (dense, no softcap): the
    split's tokens in tiles of ``tile``; warp w takes rows [w·TPW,
    (w+1)·TPW) of each tile (TPW = tile / warps) and updates its own
    (m, l, acc) once per tile; the warps merge with K2's formula."""
    B, n_kv, G, D = q.shape
    num_pages, page_size = k_pages.shape[:2]
    ppb, _, S, bps = decode_partition(tables.shape[1], pages_per_block,
                                      num_splits)
    padded = S * bps * ppb
    pages = tpa._blocked_tables(tables, lens, num_pages=num_pages,
                                page_size=page_size, window=0,
                                padded_pages=padded, pages_per_block=ppb)
    T = bps * ppb * page_size
    n_tiles, tpw = T // tile, tile // warps
    shape = (B, S, n_tiles, warps, tpw, n_kv, D)
    k = k_pages[pages.reshape(B, padded)].float().reshape(shape)
    v = v_pages[pages.reshape(B, padded)].float().reshape(shape)
    live = (torch.arange(padded * page_size)[None] < lens.long()[:, None])
    live = live.reshape(B, 1, S, 1, n_tiles, warps, tpw)
    s = torch.einsum("bkgd,bsiwtkd->bksgiwt", q.float() * scale, k)
    s = torch.where(live, s, torch.tensor(NEG_INF))
    m = torch.full((B, n_kv, S, G, warps), NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, n_kv, S, G, warps, D))
    for i in range(n_tiles):
        s_i = s[..., i, :, :]  # (B, n_kv, S, G, warps, tpw)
        m_new = torch.maximum(m, s_i.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(live[..., i, :, :], torch.exp(s_i - m_new[..., None]),
                        torch.tensor(0.0))
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bksgwt,bswtkd->bksgwd", p, v[:, :, i])
        m = m_new
    m_all = m.amax(-1)
    c = torch.exp(m - m_all[..., None])
    return m_all, (l * c).sum(-1), (acc * c[..., None]).sum(-2)


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("splits", [1, 4])
def test_warp_order_matches_plain_and_pallas_at_2048_keys(
        pallas_interpret, warps, splits):
    rng = np.random.default_rng(14)
    # the full 32-page table at page 64, D 128 (f32 K1: tiles of 16)
    q, kp, vp, tables, lens = paged_case(rng, 2, 2, 1, 128, 64, 32,
                                         [2048, 1999])
    kw = dict(scale=128 ** -0.5, pages_per_block=2, num_splits=splits)
    order = warp_order_partials(t(q), t(kp), t(vp), t(tables), t(lens),
                                warps=warps, tile=16, **kw)
    plain = tpa._paged_attention_partials_plain(
        t(q), t(kp), t(vp), t(tables), t(lens), window=0, softcap=0.0,
        kv_scale=0.0, **kw)
    pallas = jpa.paged_attention_partials(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), **kw)
    assert order[2].shape == plain[2].shape == (2, 2, splits, 1, 128)
    for a, b, c in zip(order, plain, pallas):
        close(a, b, ATTN_TOL)
        close(a, c, ATTN_TOL)


@pytest.mark.parametrize("splits", [1, 2, 4, 8, 12])
def test_decode_op_scratch_is_one_buffer_that_the_combine_takes(splits):
    rng = np.random.default_rng(3)
    q, kp, vp, tables, lens = paged_case(rng, 3, 4, 2, 64, 16, 16,
                                         [100, 7, 256])
    kw = dict(scale=0.125, window=0, softcap=0.0, kv_scale=0.0,
              pages_per_block=1, num_splits=splits)
    B, n_kv, G, D = q.shape
    name, args, buf, S, out = tpa._decode_call(
        t(q), t(kp), t(vp), t(tables), t(lens), combine=True, **kw)
    assert S == splits
    # the C call's arguments are its signature's, but the stream
    assert len(args) + 1 == len(build.SIGNATURES[name])
    # K1's partials into one buffer, then K2 into the op's output (B,
    # n_kv, G, D) in the q dtype, whose pointer follows acc's: at one
    # split too
    assert name == "paged_decode_attention"
    assert out.shape == (B, n_kv, G, D) and out.dtype == torch.float32
    assert args[10] == out.data_ptr()
    # K1 alone: the same buffer's layout and no output
    alone = tpa._decode_call(t(q), t(kp), t(vp), t(tables), t(lens),
                             combine=False, **kw)
    assert alone[0] == "paged_decode_partials" and alone[4] is None
    assert len(alone[1]) + 1 == len(build.SIGNATURES[alone[0]])
    assert alone[2].numel() == buf.numel()
    m, l, acc = tpa._scratch_views(buf, B, n_kv, S, G, D)
    n = B * n_kv * S * G
    for x, shape in ((m, (B, n_kv, S, G)), (l, (B, n_kv, S, G)),
                     (acc, (B, n_kv, S, G, D))):
        # exactly what combine_partials_kernel checks before a launch
        assert x.dtype == torch.float32 and tuple(x.shape) == shape
        assert x.is_contiguous()
        assert (x.untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr())
    assert buf.numel() == n * (D + 2)
    # the C call's pointers are the views' addresses, in its order
    assert args[7:10] == (m.data_ptr(), l.data_ptr(), acc.data_ptr())
    # filled, they combine like separately allocated partials
    m.copy_(t(rng.standard_normal(m.shape).astype(np.float32)))
    l.copy_(t(rng.random(l.shape).astype(np.float32)))
    acc.copy_(t(rng.standard_normal(acc.shape).astype(np.float32)))
    close(tpa.combine_partials_kernel(m, l, acc),
          tpa._combine_partials_plain(m.clone(), l.clone(), acc.clone()),
          0.0)


@pytest.mark.parametrize("lens", [[1124, 2048, 1], [64, 513, 2000]])
def test_decode_op_matches_jax_at_the_engine_partition(pallas_interpret,
                                                       lens):
    rng = np.random.default_rng(len(lens) + lens[0])
    q, kp, vp, tables, lens = paged_case(rng, 3, 4, 1, 128, 64, 32, lens)
    kw = dict(scale=128 ** -0.5, pages_per_block=2, num_splits=4)
    got = tpa.paged_attention_kernel(t(q), t(kp), t(vp), t(tables),
                                     t(lens), **kw)
    want = jpa.paged_attention_kernel(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), **kw)
    assert got.shape == (3, 4, 1, 128) and got.dtype == torch.float32
    close(got, np.asarray(want), ATTN_TOL)


def test_decode_op_counts_nothing_on_the_cpu():
    rng = np.random.default_rng(1)
    q, kp, vp, tables, lens = paged_case(rng, 2, 2, 1, 64, 16, 4, [9, 50])
    k1 = tpa.paged_attention_partials.launches
    k2 = tpa.combine_partials_kernel.launches
    for splits in (1, 2):
        tpa.paged_attention_kernel(t(q), t(kp), t(vp), t(tables), t(lens),
                                   scale=0.125, num_splits=splits)
    assert tpa.paged_attention_partials.launches == k1
    assert tpa.combine_partials_kernel.launches == k2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("D", [64, 128, 192])
@pytest.mark.parametrize("page", [1, 7, 8, 16, 31, 32, 33, 64])
def test_decode_page_supported_by_tma_alignment(dtype, D, page):
    # a page shorter than the tile is one TMA box placed at a 128-byte
    # aligned stage offset (a gap follows a page of other bytes), so every
    # page is taken, odd int8 pages at D = 64 and 192 among them
    assert tpa.decode_supported(dtype, D, 1, page)
