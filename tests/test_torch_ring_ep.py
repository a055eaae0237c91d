"""Ring attention and expert parallelism on ``gloo`` ranks against the
JAX package's sharded functions.

One JAX subprocess with 8 fake CPU devices computes every reference of
the file: ``prefill_attention(impl="ring")`` on the three shapes of
``tests/test_distributed_multi.py`` (mesh (2, 4), batch over "data",
sequence over "model") and ``apply_moe_ep`` on the granite-moe smoke
layer (4 experts, top 2) on meshes (1, 2), (2, 2) and (1, 4) at the
config's capacity 1.25, every row live, and dropless (0.0).  The port
runs the same cases on 4-rank (and, for EP, 2-rank) ``gloo`` groups:
each rank its sequence slice of its batch rows (ring) or its rows with
its experts (EP).  Tolerance ``ATTN_TOL`` (2e-5).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_helpers import ATTN_TOL, close

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

RING_SHAPES = {  # test_distributed_multi.py's (B, S, H, Hkv, D, window, lens)
    "gqa": (2, 64, 8, 2, 16, 0, None),
    "window": (2, 128, 4, 4, 32, 30, None),
    "padded": (2, 64, 8, 4, 16, 0, [50, 33]),
}
EP_MESHES = [(1, 2), (2, 2), (1, 4)]
EP_CAPS = [1.25, 0.0]


def _inputs():
    rng = np.random.default_rng(0)
    ring = {}
    for name, (B, S, H, Hkv, D, window, lens) in RING_SHAPES.items():
        ring[name] = dict(
            q=rng.standard_normal((B, S, H, D)).astype(np.float32),
            k=rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            v=rng.standard_normal((B, S, Hkv, D)).astype(np.float32),
            window=window,
            lens=None if lens is None else np.asarray(lens, np.int32))
    x = rng.standard_normal((4, 8, 256)).astype(np.float32)
    return ring, x


def _padded(x):
    """A wave of a 4-token row beside a 32-token row (the MoE fault test's
    shape), row 0's padding (positions 4..) drawn twice: the two
    versions of the wave."""
    rng = np.random.default_rng(1)
    # a shared direction makes the router favour the same experts, so
    # capacity binds: padding along it, or against it
    base = 2 * rng.standard_normal(x.shape[-1])
    a = (base + rng.standard_normal((2, 32, x.shape[-1]))).astype(np.float32)
    b = a.copy()
    b[0, 4:] = -base + rng.standard_normal(b[0, 4:].shape)
    return a, b


def _live(x):
    live = np.ones(x.shape[:2], bool)
    live[0, 4:] = False
    return live


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.core.attention import prefill_attention
from repro.distributed import ep
from repro.distributed.sharding import use_mesh, DEFAULT_RULES
from repro.models import moe
from repro.models.api import build_model
ring, x, meshes, caps, pad_a, pad_b = pickle.load(open({inp!r}, "rb"))
out = {{"ring": {{}}, "ep": {{}}}}
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = DEFAULT_RULES.extend(batch=("data",), seq=("model",), heads=None,
                             kv_heads=None)
for name, c in ring.items():
    q, k, v = (jnp.asarray(c[n]) for n in ("q", "k", "v"))
    l = None if c["lens"] is None else jnp.asarray(c["lens"])
    w = c["window"]
    with use_mesh(mesh, rules):
        o = jax.jit(lambda q, k, v: prefill_attention(
            q, k, v, window=w, lens=l, impl="ring"))(q, k, v)
    out["ring"][name] = np.asarray(o)
    out["ring"][name + "/dense"] = np.asarray(prefill_attention(
        q, k, v, window=w, lens=l, impl="jnp"))
cfg0 = get_config("granite-moe-1b-a400m").smoke()
params = build_model(cfg0).init_params(jax.random.PRNGKey(0))
p = jax.tree_util.tree_map(lambda a: a[0], params["groups"]["0A"])["moe"]
out["p"] = jax.tree_util.tree_map(np.asarray, p)
xj = jnp.asarray(x)
for cap in caps:
    cfg = cfg0.replace(moe_capacity=cap, moe_ep=True)
    out["ep"]["single/%s" % cap] = np.asarray(moe.apply_moe(p, xj, cfg)[0])
    for shape in meshes:
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        m = Mesh(devs, ("data", "model"))
        r = DEFAULT_RULES.extend(batch=("data",) if shape[0] > 1 else None)
        with use_mesh(m, r):
            o, aux = jax.jit(lambda p, x: ep.apply_moe_ep(p, x, cfg))(p, xj)
        out["ep"]["%s/%s" % (shape, cap)] = (np.asarray(o), float(aux))
    # row 0 live for 4 tokens; its padding (positions 4..) in two versions
    m2 = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    for tag, xp in (("a", pad_a), ("b", pad_b)):
        with use_mesh(m2, DEFAULT_RULES.extend(batch=None)):
            o, _ = jax.jit(lambda p, x: ep.apply_moe_ep(p, x, cfg))(
                p, jnp.asarray(xp))
        out["ep"]["pad/%s/%s" % (cap, tag)] = np.asarray(o)
pickle.dump(out, open({outp!r}, "wb"))
"""


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_ep_jax")
    ring, x = _inputs()
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump((ring, x, EP_MESHES, EP_CAPS) + _padded(x), f)
    code = _JAX.format(src=os.path.abspath(SRC), inp=inp, outp=outp)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(outp, "rb") as f:
        return ring, x, pickle.load(f)


@pytest.fixture(scope="module")
def ring_ranks(tmp_path_factory, refs):
    ring, _, _ = refs
    return {shape: run_ranks(tmp_path_factory.mktemp("ring"), "ring_cases",
                             {"cases": ring}, shape)
            for shape in ((1, 4), (2, 2))}


@pytest.fixture(scope="module")
def ep_ranks(tmp_path_factory, refs):
    _, x, out = refs
    cases = {str(cap): {"capacity": cap, "p": out["p"], "x": x}
             for cap in EP_CAPS}
    for tag, xp in zip("ab", _padded(x)):
        cases[f"pad/{tag}"] = {"capacity": 1.25, "p": out["p"], "x": xp,
                               "live": _live(xp)}
    return {shape: run_ranks(tmp_path_factory.mktemp("ep"), "ep_cases",
                             {"cases": cases}, shape)
            for shape in EP_MESHES}


@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_jax_ring_reference_is_dense(refs, name):
    _, _, out = refs
    close(out["ring"][name], out["ring"][name + "/dense"], 3e-5)


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", list(RING_SHAPES))
def test_ring_attention_matches_jax_ring(refs, ring_ranks, shape, name):
    _, _, out = refs
    want = out["ring"][name]
    for res in ring_ranks[shape]:
        b0, b1, s0, s1 = res[f"{name}/where"]
        close(res[name], want[b0:b1, s0:s1], ATTN_TOL)


@pytest.mark.parametrize("shape", EP_MESHES)
@pytest.mark.parametrize("cap", EP_CAPS)
def test_apply_moe_ep_matches_jax_ep(refs, ep_ranks, shape, cap):
    """Per-rank capacity on the same mesh: the outputs of every rank's
    rows and the load-balance loss."""
    _, _, out = refs
    want, aux = out["ep"][f"{shape}/{cap}"]
    for res in ep_ranks[shape]:
        b0, b1 = res[f"{cap}/rows"]
        close(res[str(cap)], want[b0:b1], ATTN_TOL)
        assert abs(res[f"{cap}/aux"] - aux) <= ATTN_TOL * (1 + abs(aux))


@pytest.mark.parametrize("shape", EP_MESHES)
def test_dropless_ep_is_the_single_device_moe(refs, ep_ranks, shape):
    _, _, out = refs
    want = out["ep"]["single/0.0"]
    for res in ep_ranks[shape]:
        b0, b1 = res["0.0/rows"]
        close(res["0.0"], want[b0:b1], ATTN_TOL)


def test_jax_ep_capacity_counts_padding(refs):
    """The JAX EP ranks every row of the rank's batch in ``T_l``
    (``ep.py:67,84``), as its ``apply_moe`` does: changing only row 0's
    padding moves row 1's output at the capacity factor 1.25, and not at
    all when dropless."""
    _, _, out = refs
    moved = np.abs(out["ep"]["pad/1.25/a"][1]
                   - out["ep"]["pad/1.25/b"][1]).max()
    print(f"JAX EP: row 1 moved by {moved:.3e} at 1.25")
    assert moved > 10 * ATTN_TOL
    assert np.abs(out["ep"]["pad/0.0/a"][1]
                  - out["ep"]["pad/0.0/b"][1]).max() == 0.0


def test_port_ep_rows_do_not_see_the_padding(ep_ranks):
    """The port's EP routes only the live tokens: on (1, 2), row 1 does
    not move when row 0's padding changes, at 1.25, and the padding's
    output is zero."""
    for res in ep_ranks[(1, 2)]:
        a, b = res["pad/a"], res["pad/b"]
        np.testing.assert_array_equal(a[1:], b[1:])
        np.testing.assert_array_equal(a[0, :4], b[0, :4])
        assert not a[0, 4:].any()


def test_ring_refuses_a_mesh_whose_rules_keep_seq_whole():
    """On a 2-rank "model" axis under the default rules (``seq`` whole)
    the tensors are not sequence slices: ``impl="ring"`` raises instead of
    attending within each rank's slice; with no mesh, or one rank on
    "model", the slice is the whole sequence and the chunked path runs."""
    import torch
    from repro_torch.core.attention import prefill_attention
    from repro_torch.distributed.sharding import DEFAULT_RULES, use_mesh
    from repro_torch.errors import EngineConfigError
    from repro_torch.launch.mesh import Mesh
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 16, 4, 8)).astype(
        np.float32)) for _ in range(3))
    with use_mesh(Mesh((1, 2)), DEFAULT_RULES):
        with pytest.raises(EngineConfigError):
            prefill_attention(q, k, v, impl="ring")
    want = prefill_attention(q, k, v, impl="chunked")
    assert torch.equal(prefill_attention(q, k, v, impl="ring"), want)
    with use_mesh(Mesh((2, 1)), DEFAULT_RULES.extend(seq=("model",))):
        assert torch.equal(prefill_attention(q, k, v, impl="ring"), want)
