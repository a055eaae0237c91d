"""PyTorch port: K2's plain version at K3's layout and its launch counts.

- The plain combine of K3's native layout (``_combine_prefill_plain``:
  m, l (B, Hkv, NQ, S, R), acc (B, Hkv, NQ, S, R, D) into (B, C, H, D))
  against the JAX ``combine_prefill_partials`` in both its modes ("jnp"
  and the Pallas kernel in interpret mode) at ``ATTN_TOL``, with a chunk
  that q_block does not divide and all-dead rows; and against the port's
  fold-then-combine path on the CPU to the last bit in f32.
- K2's per-layout launch counts in ``launch_counts``.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import core  # noqa: F401  (before the kernels' wrappers)
from repro_torch import kernels
from repro_torch.kernels.paged_attention import paged_attention as tpa

jpa = importlib.import_module(
    "repro.kernels.paged_attention.paged_attention")

from _torch_helpers import ATTN_TOL, close, pallas_interpret, t  # noqa: F401


def prefill_partials(rng, B, Hkv, NQ, S, q_block, G, D):
    """K3-shaped partials with empty splits and all-dead rows (every split
    (NEG_INF, 0, 0), as K3 leaves a row past its chunk)."""
    R = q_block * G
    m = rng.standard_normal((B, Hkv, NQ, S, R)).astype(np.float32) * 3
    l = rng.uniform(0.5, 4.0, (B, Hkv, NQ, S, R)).astype(np.float32)
    acc = rng.standard_normal((B, Hkv, NQ, S, R, D)).astype(np.float32)
    dead = [(0, 0, 0, 0, slice(0, 3))]  # one split of three rows empty
    dead += [(1, Hkv - 1, NQ - 1, s, slice(None)) for s in range(S)]
    dead += [(0, 0, 1, s, slice(R - G, R)) for s in range(S)]  # a token
    for b, h, nq, s, rows in dead:
        m[b, h, nq, s, rows] = -1e30
        l[b, h, nq, s, rows] = 0.0
        acc[b, h, nq, s, rows] = 0.0
    return m, l, acc


@pytest.mark.parametrize("mode", ["jnp", "pallas"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 6])
@pytest.mark.parametrize("S", [1, 2, 3])
def test_prefill_plain_matches_jax_combine_prefill(pallas_interpret, S, G, D,
                                                    mode):
    rng = np.random.default_rng(100 * S + 10 * G + D // 64)
    B, Hkv, NQ, q_block = 2, 2, 3, 3
    C = NQ * q_block - 2  # q_block does not divide the chunk
    m, l, acc = prefill_partials(rng, B, Hkv, NQ, S, q_block, G, D)
    plain = tpa._combine_prefill_plain(t(m), t(l), t(acc), C, q_block)
    ref = jpa.combine_prefill_partials(jnp.asarray(m), jnp.asarray(l),
                                       jnp.asarray(acc), C, q_block,
                                       mode=mode, interpret=True)
    assert plain.shape == (B, C, Hkv * G, D) and plain.dtype == torch.float32
    close(plain, ref, ATTN_TOL)
    # the dead rows (batch 1, the last kv head, the last Q-block) are zeros
    last = (NQ - 1) * q_block
    dead = plain[1, last:, (Hkv - 1) * G:]
    assert torch.equal(dead, torch.zeros_like(dead))
    # the Q-blocks folded into the batch and merged by the plain decode
    # combine (how the CPU path ran before), to the last bit
    B_, R = B * NQ, q_block * G
    fold = [x.transpose(1, 2).reshape(B_, Hkv, S, R, *x.shape[5:])
            for x in (t(m), t(l), t(acc))]
    fold = tpa._combine_partials_plain(*fold).reshape(
        B, NQ, Hkv, q_block, G, D).permute(0, 1, 3, 2, 4, 5)
    assert torch.equal(plain, fold.reshape(B, NQ * q_block, Hkv * G, D)[:, :C])
    # the wrapper's CPU path is the plain version
    assert torch.equal(
        tpa.combine_prefill_partials(t(m), t(l), t(acc), C, q_block), plain)
    bf16 = tpa._combine_prefill_plain(t(m), t(l), t(acc), C, q_block,
                                      dtype=torch.bfloat16)
    assert torch.equal(bf16, plain.to(torch.bfloat16))


def test_one_split_is_the_plain_normalise_bit_for_bit():
    rng = np.random.default_rng(7)
    m, l, acc = prefill_partials(rng, 2, 2, 2, 1, 4, 3, 64)
    want = t(acc)[:, :, :, 0] / torch.clamp(t(l)[:, :, :, 0, :, None],
                                            min=1e-30)
    got = tpa._combine_prefill_plain(t(m), t(l), t(acc), 8, 4)
    assert torch.equal(got, want.reshape(2, 2, 2, 4, 3, 64).permute(
        0, 2, 3, 1, 4, 5).reshape(2, 8, 6, 64))
    dm, dl, dacc = (x[:, :, 0] for x in (m, l, acc))  # (B, Hkv, 1, R...)
    assert torch.equal(tpa.combine_partials_kernel(t(dm), t(dl), t(dacc)),
                       t(dacc)[:, :, 0] / torch.clamp(
                           t(dl)[:, :, 0, :, None], min=1e-30))


def test_combine_route_counts_in_launch_counts_and_reset():
    counts = kernels.launch_counts()
    assert {k for k in counts if k.startswith("combine/")} == {
        "combine/decode", "combine/prefill", "combine/dist"}
    tpa.combine_partials_kernel.launches_by_route["prefill"] += 2
    assert kernels.launch_counts()["combine/prefill"] >= 2
    kernels.reset_launch_counts()
    assert all(n == 0 for n in kernels.launch_counts().values())


def test_decode_op_on_the_cpu_takes_no_route_and_counts_nothing():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(3)
    q = t(rng.standard_normal((2, 2, 3, 64)).astype(np.float32))
    kp = t(rng.standard_normal((20, 8, 2, 64)).astype(np.float32))
    tables = t(np.arange(20, dtype=np.int32).reshape(2, 10))
    lens = t(np.array([70, 3], np.int32))
    for splits in (1, 4, 10):
        out = tpa.paged_attention_kernel(q, kp, kp, tables, lens, scale=0.125,
                                         num_splits=splits)
        assert out.shape == (2, 2, 3, 64)
    assert all(n == 0 for n in kernels.launch_counts().values())
