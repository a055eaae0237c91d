"""PyTorch port: chunked paged prefill (K3) against the JAX package — K3's
plain partials against the Pallas ``_prefill_kernel`` (interpret mode),
split by split; the ``paged_prefill`` op and its oracle against the JAX
oracle on live rows (int8 pools and softcap included); the single-token
chunk against the decode oracle; ``choose_prefill_params`` and
``combine_prefill_partials`` against theirs.  All at ``ATTN_TOL``."""

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

from _torch_helpers import ATTN_TOL, close, pallas_interpret, t  # noqa: F401

# B, H, Hkv, D, page, max_pages, kv_lens, q_start — the sweep of
# tests/test_chunked_prefill.py
PREFILL_SWEEP = [
    (1, 4, 4, 32, 8, 4, [25], [9]),            # MHA, mid-prompt resume
    (2, 8, 2, 16, 8, 5, [29, 11], [13, 0]),    # GQA, mixed resume points
    (2, 4, 1, 16, 4, 6, [23, 8], [0, 3]),      # MQA, whole-prompt row
    (3, 4, 2, 16, 16, 2, [17, 32, 5], [16, 15, 0]),  # single-token chunk row
]


def prefill_case(seed, B, H, Hkv, D, page, max_pages, kv_lens, q_start,
                 int8=False):
    """numpy (q (B,C,H,D), pools, tables, kv_lens, q_start): each row's
    live pages scattered through a permuted pool, -1 past them."""
    rng = np.random.default_rng(seed)
    num_pages = B * max_pages + 3
    kv_lens = np.asarray(kv_lens, np.int32)
    q_start = np.asarray(q_start, np.int32)
    C = int((kv_lens - q_start).max())
    q = rng.standard_normal((B, C, H, D)).astype(np.float32)
    shape = (num_pages, page, Hkv, D)
    if int8:
        kp = rng.integers(-127, 128, shape, dtype=np.int8)
        vp = rng.integers(-127, 128, shape, dtype=np.int8)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(num_pages)
    tables = np.full((B, max_pages), -1, np.int32)
    k = 0
    for b in range(B):
        n = -(-int(kv_lens[b]) // page)
        tables[b, :n] = perm[k:k + n]
        k += n
    return q, kp, vp, tables, kv_lens, q_start


@pytest.mark.parametrize("ppb,splits,q_block",
                         [(1, 1, 1), (2, 1, 3), (2, 3, 2), (3, 2, 128)])
@pytest.mark.parametrize("case", range(len(PREFILL_SWEEP)))
def test_prefill_partials_match_pallas_split_by_split(pallas_interpret, case,
                                                      ppb, splits, q_block):
    arrs = prefill_case(case, *PREFILL_SWEEP[case])
    D = arrs[0].shape[-1]
    kw = dict(scale=D ** -0.5, pages_per_block=ppb, num_splits=splits,
              q_block=q_block)
    port = tpa.paged_prefill_partials(*map(t, arrs), **kw)
    pallas = jpa.paged_prefill_partials(*map(jnp.asarray, arrs),
                                        interpret=True, **kw)
    S = pallas[0].shape[3]
    assert port[0].shape == pallas[0].shape
    assert port[2].shape == pallas[2].shape
    for s in range(S):  # split by split, every row of every Q-block
        for a, b in zip(port, pallas):
            close(a[:, :, :, s], b[:, :, :, s], ATTN_TOL)
    # the oracles clamp q_block to the chunk: theirs agree split by split
    oracle = jref.paged_prefill_partials_ref(*map(jnp.asarray, arrs), **kw)
    port_oracle = tref.paged_prefill_partials_ref(*map(t, arrs), **kw)
    for a, b in zip(port_oracle, oracle):
        assert a.shape == b.shape
        close(a, b, ATTN_TOL)


VARIANTS = {f"sweep{i}": (PREFILL_SWEEP[i], {}) for i in range(4)}
VARIANTS["int8"] = ((2, 4, 2, 16, 8, 4, [30, 12], [8, 0]),
                    dict(int8=True, kv_scale=0.05))
VARIANTS["softcap"] = ((2, 8, 2, 16, 8, 5, [29, 11], [13, 0]),
                       dict(softcap=5.0))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_paged_prefill_matches_reference_on_live_rows(name):
    case, opts = VARIANTS[name]
    arrs = prefill_case(11, *case, int8=opts.get("int8", False))
    kw = dict(softcap=opts.get("softcap", 0.0),
              kv_scale=opts.get("kv_scale", 0.0))
    ref = np.asarray(jops.paged_prefill(*map(jnp.asarray, arrs), impl="ref",
                                        **kw))
    kernel = tops.paged_prefill(*map(t, arrs), impl="kernel",
                                pages_per_block=2, num_splits=2, q_block=3,
                                **kw)
    auto = tops.paged_prefill(*map(t, arrs), impl="kernel", **kw)
    oracle = tops.paged_prefill(*map(t, arrs), impl="ref", **kw)
    kv_lens, q_start = arrs[4], arrs[5]
    for b in range(len(kv_lens)):  # only live chunk rows are specified
        ql = int(kv_lens[b] - q_start[b])
        for out in (kernel, auto, oracle):
            close(out[b, :ql], ref[b, :ql], ATTN_TOL)


def test_single_token_chunk_equals_decode_oracle():
    """C == 1 at q_start == kv_lens - 1 is paged decode."""
    arrs = prefill_case(5, 2, 4, 2, 16, 8, 3, [17, 9], [16, 8])
    q, kp, vp, tables, kv_lens, _ = map(t, arrs)
    dec = tref.paged_attention_ref(q[:, 0], kp, vp, tables, kv_lens)
    for impl in ("kernel", "ref"):
        pre = tops.paged_prefill(*map(t, arrs), impl=impl, num_splits=2)
        close(pre[:, 0], dec, ATTN_TOL)


def test_choose_prefill_params_equals_reference():
    for mp in (1, 3, 7, 32, 257):
        for page in (8, 64):
            for chunk, group in ((1, 1), (13, 4), (512, 1), (96, 8)):
                for ppb, ns, qb in ((None, None, None), (2, 3, 2),
                                    (None, 2, 1000), (1, 1, 5)):
                    ref = jops.choose_prefill_params(
                        mp, page, 128, chunk, group, ppb, ns, q_block=qb,
                        backend="tpu")
                    port = tops.choose_prefill_params(mp, page, 128, chunk,
                                                      group, ppb, ns, qb)
                    assert port == (ref[0], ref[1], ref[3])
    # the main path: llama2-7b, 2048-token tables, chunks of 512
    assert tops.choose_prefill_params(32, 64, 128, 512, 1) == (2, 1, 128)


@pytest.mark.parametrize("S", [1, 3])
def test_combine_prefill_partials_equals_reference(S):
    rng = np.random.default_rng(S)
    B, Hkv, NQ, q_block, G, D, C = 2, 2, 3, 4, 2, 8, 10
    R = q_block * G
    m = rng.standard_normal((B, Hkv, NQ, S, R)).astype(np.float32)
    m[0, 0, 0, 0] = -1e30  # an empty split
    l = rng.uniform(0.5, 3.0, (B, Hkv, NQ, S, R)).astype(np.float32)
    l[0, 0, 0, 0] = 0.0
    acc = rng.standard_normal((B, Hkv, NQ, S, R, D)).astype(np.float32)
    acc[0, 0, 0, 0] = 0.0
    ref = jpa.combine_prefill_partials(jnp.asarray(m), jnp.asarray(l),
                                       jnp.asarray(acc), C, q_block,
                                       mode="jnp")
    port = tpa.combine_prefill_partials(t(m), t(l), t(acc), C, q_block)
    assert port.shape == (B, C, Hkv * G, D)
    close(port, ref, ATTN_TOL)


def test_prefill_wrapper_runs_plain_only_for_cpu_tensors():
    """On the CPU the K3 wrapper runs its plain version and counts
    nothing; a tensor on another device raises instead of falling back."""
    arrs = list(map(t, prefill_case(0, *PREFILL_SWEEP[1])))
    before = tpa.paged_prefill_partials.launches
    tpa.paged_prefill_partials(*arrs, scale=0.25, q_block=2)
    assert tpa.paged_prefill_partials.launches == before
    arrs[0] = torch.empty(arrs[0].shape, device="meta")
    with pytest.raises(Exception, match="device"):
        tpa.paged_prefill_partials(*arrs, scale=0.25)
