"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages.  The
JAX package's Pallas kernels run in interpret mode; under JAX 0.9 they need
``pltpu.TPUCompilerParams`` aliased to ``pltpu.CompilerParams``, which the
``pallas_interpret`` fixture does for one test at a time (a process-wide
alias would hide the reference suites' own failures).
"""

import numpy as np
import pytest
import torch

# The tests run 6 workers at once; torch's default of one intra-op thread
# per core would oversubscribe the host and slow every worker's JAX tests.
# The port's test shapes are tiny, so one thread costs them nothing.
torch.set_num_threads(1)

# Tolerances, stated once: f32 attention modules agree to 2e-5; model
# logits to 1e-4, because XLA and torch's CPU matmuls sum in other orders.
ATTN_TOL = 2e-5
LOGIT_TOL = 1e-4


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental.pallas import tpu as pltpu
    monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                        raising=False)


def t(x, dtype=None):
    """numpy / jax array → CPU torch tensor."""
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def paged_case(rng, B, Hkv, G, D, page, max_pages, lens, kv_dtype=np.float32,
               extra_pages=3):
    """Random scattered paged cache: (q (B,Hkv,G,D), k/v pools, tables
    (B, max_pages) with -1 past each row's live pages, lens), numpy."""
    num_pages = B * max_pages + extra_pages
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    if kv_dtype == np.int8:
        kp = rng.integers(-127, 128, (num_pages, page, Hkv, D), dtype=np.int8)
        vp = rng.integers(-127, 128, (num_pages, page, Hkv, D), dtype=np.int8)
    else:
        kp = rng.standard_normal((num_pages, page, Hkv, D)).astype(kv_dtype)
        vp = rng.standard_normal((num_pages, page, Hkv, D)).astype(kv_dtype)
    perm = rng.permutation(num_pages)
    tables = np.full((B, max_pages), -1, np.int32)
    lens = np.asarray(lens, np.int32)
    k = 0
    for b in range(B):
        n = min(-(-int(lens[b]) // page), max_pages)
        tables[b, :n] = perm[k:k + n]
        k += n
    return q, kp, vp, tables, lens
