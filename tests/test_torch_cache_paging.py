"""PyTorch port: the host page manager makes the JAX package's decisions on
a seeded op sequence, and the paged K/V writes (in place in the port)
match the JAX scatters — including a dead row whose -1 table entries must
leave the pool's last page untouched."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core.paging import HostPageManager as JMgr
from repro.distributed.collectives import write_decode_sharded
from repro_torch.core import cache as tcache
from repro_torch.core.paging import HostPageManager as TMgr

from _torch_helpers import t


def _state(m):
    return (list(m.free_list), list(m.refcount),
            {k: list(v) for k, v in m.tables.items()}, dict(m.lens),
            m.used_pages, m.available_pages)


def _apply(m, op, *args):
    try:
        return ("ok", getattr(m, op)(*args))
    except Exception as e:  # the exception type is part of the decision
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_page_manager_decisions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = JMgr(24, 4), TMgr(24, 4)
    for _ in range(400):
        op = rng.choice(["reserve", "extend", "free", "fork"])
        rid = int(rng.integers(0, 8))
        args = {"reserve": (rid, int(rng.integers(0, 30))),
                "extend": (rid, int(rng.integers(1, 6))),
                "free": (rid,),
                "fork": (rid, int(rng.integers(8, 12)))}[op]
        assert _apply(port, op, *args) == _apply(ref, op, *args), (op, args)
        assert _state(port) == _state(ref)
    assert _state(port.clone()) == _state(ref.clone())
    assert port.overhead_frac(2, 8, 3) == ref.overhead_frac(2, 8, 3)


def _pools(rng, num_pages=12, page=4, H=2, D=8):
    k = rng.standard_normal((num_pages, page, H, D)).astype(np.float32)
    return k, k + 100.0


@pytest.mark.parametrize("window", [0, 6])
def test_prefill_write_equals_reference(window):
    rng = np.random.default_rng(3)
    kp, vp = _pools(rng)
    B, S, H, D = 3, 11, 2, 8
    k = rng.standard_normal((B, S, H, D)).astype(np.float32)
    v = rng.standard_normal((B, S, H, D)).astype(np.float32)
    tables = np.array([[3, 7, 1], [5, 0, -1], [-1, -1, -1]], np.int32)
    lens = np.array([11, 6, 9], np.int32)  # row 2 is dead (all -1)
    jk, jv = jcache.write_layer_prefill(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), window=window)
    tk, tv = t(kp), t(vp)
    tcache.write_layer_prefill(tk, tv, t(tables), t(k), t(v), t(lens),
                               window=window)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_decode_write_equals_reference_and_drops_null_rows():
    rng = np.random.default_rng(4)
    kp, vp = _pools(rng)
    last = kp.shape[0] - 1
    B, H, D = 4, 2, 8
    # row 2 is dead (-1 everywhere): torch's pages[-1] would hit `last`
    tables = np.array([[[3, 7, 1]], [[5, 0, 2]], [[-1, -1, -1]],
                       [[9, -1, -1]]], np.int32)
    positions = np.array([9, 4, 5, 6], np.int32)  # row 3: page 1 is NULL
    k = rng.standard_normal((B, H, D)).astype(np.float32)
    v = rng.standard_normal((B, H, D)).astype(np.float32)
    jk, jv = write_decode_sharded(
        jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tables),
        jnp.asarray(positions), jnp.asarray(k), jnp.asarray(v))
    tk, tv = t(kp), t(vp)
    tcache.write_layer_decode(tk, tv, t(tables), t(positions), t(k), t(v))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert torch.equal(tk[last], t(kp[last]))
    assert torch.equal(tv[last], t(vp[last]))
    assert not torch.equal(tk[1], t(kp[1]))  # live rows did write
