"""The port's distributed layer against the JAX package: sharding rules
and plans, kvp flash-decoding over page stripes, tp/dp decode attention
and the cache writes of every scheme.

The port's side runs as real ``torch.distributed`` ``gloo`` groups of 2
and 4 CPU processes (``_torch_dist.run_ranks``; one start per group for
every case).  The JAX side: the rules and plans in this process (they
read only the mesh's axis names and shape); kvp's sharded function on 8
fake CPU devices in one subprocess for the whole file, with the Pallas
combine run in interpret mode under the compiler-params alias
(``_torch_helpers.pallas_interpret``, set inside that subprocess); the
tp/dp attention and the writes against the JAX local functions on the
whole problem, cut to each rank's part.  Tolerance ``ATTN_TOL`` (2e-5);
the writes are exact.
"""

import os
import subprocess
import sys
import textwrap
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_helpers import ATTN_TOL, close

from repro_torch.configs import get_config as get_config_t
from repro_torch.configs.base import RunConfig as RunConfigT
from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import (P, AxisRules, DEFAULT_RULES,
                                              current_mesh, logical_spec,
                                              use_mesh)
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.launch.steps import plan_for

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


# ---------------------------------------------------------------------------
# logical-axis rules (tests/test_sharding.py's, on the port)
# ---------------------------------------------------------------------------
def test_logical_spec_basic():
    rules = AxisRules({"batch": ("pod", "data"), "heads": "model"})
    spec = logical_spec(("batch", None, "heads"), rules, mesh=None)
    assert spec == P(("pod", "data"), None, "model")


def test_logical_spec_drops_duplicate_mesh_axes():
    rules = AxisRules({"seq": ("model",), "vocab": ("model",)})
    assert logical_spec(("seq", "vocab"), rules, mesh=None) == P("model")


def test_logical_spec_divisibility_fallback():
    mesh = Mesh((1, 1), ("data", "model"))
    rules = AxisRules({"heads": ("model",)})
    assert logical_spec(("heads",), rules, mesh=mesh, shape=(7,)) == P(
        "model")
    mesh = Mesh((1, 2), ("data", "model"))
    assert logical_spec(("heads",), rules, mesh=mesh, shape=(7,)) == P()


def test_config_overrides_extend_rules():
    rules = DEFAULT_RULES.extend(embed=("data",))
    assert rules.physical("embed") == ("data",)
    assert rules.physical("heads") == ("model",)


def test_plan_scheme_selection():
    run = RunConfigT(model=get_config_t("granite-8b"), seq_len=32_768,
                     global_batch=128, kind="decode")
    assert plan_for(run, Mesh((1, 1))).scheme == "tp"


def test_use_mesh_restores_context():
    mesh = make_local_mesh()
    assert current_mesh() is None
    with use_mesh(mesh):
        assert current_mesh() is mesh
    assert current_mesh() is None


def _jax_mesh(shape, names):
    """What the JAX rules and plans read of a mesh: names and shape."""
    return types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.empty(shape))


RULE_CASES = [
    (("batch", None, "heads"), (8, 3, 16), (2, 4), ("data", "model")),
    (("batch", "seq", "vocab"), (8, 16, 30), (2, 4), ("data", "model")),
    (("embed", "mlp"), (64, 96), (4, 2), ("data", "model")),
    (("vocab", "embed"), (49155, 64), (1, 2), ("data", "model")),
    (("experts", "embed", None), (32, 64, 8), (2, 2, 4),
     ("pod", "data", "model")),
    (("batch", "kv_pages", None), (4, 64, 8), (2, 2, 4),
     ("pod", "data", "model")),
    (("heads", "kv_heads"), (48, 8), (1, 16), ("data", "model")),
    (("seq", "heads"), (64, 8), (2, 4), ("data", "model")),
]


@pytest.mark.parametrize("axes,shape,mshape,names", RULE_CASES)
@pytest.mark.parametrize("overrides", [
    {}, {"embed": ("data",), "kv_heads": ("model",)},
    {"seq": ("model",), "batch": ("data",)}])
def test_logical_spec_matches_jax(axes, shape, mshape, names, overrides):
    from repro.distributed.sharding import DEFAULT_RULES as JR
    from repro.distributed.sharding import logical_spec as jspec
    got = logical_spec(axes, DEFAULT_RULES.extend(**overrides),
                       Mesh(mshape, names), shape)
    want = jspec(axes, JR.extend(**overrides), _jax_mesh(mshape, names),
                 shape)
    assert tuple(got) == tuple(want)


PLAN_CONFIGS = ["llama2-7b", "granite-8b", "nemotron-4-15b", "llama3-405b",
                "granite-moe-1b-a400m", "recurrentgemma-9b"]


def _plans_match_jax(name, mshape, scheme, ws_decode):
    """``plan_for`` of the decode, prefill and train runs of ``name`` on
    ``mshape`` against the JAX ``plan_for`` with the same knobs."""
    from repro.configs import get_config as jget
    from repro.configs.base import RunConfig as JRun
    from repro.launch.steps import plan_for as jplan
    names = ("data", "model")
    for B, S in ((8, 4096), (1, 8192)):
        got = plan_for(RunConfigT(model=get_config_t(name), seq_len=S,
                                  global_batch=B, kind="decode"),
                       Mesh(mshape, names), scheme=scheme,
                       ws_decode=ws_decode)
        want = jplan(JRun(model=jget(name), seq_len=S, global_batch=B,
                          kind="decode"), _jax_mesh(mshape, names),
                     scheme=scheme, ws_decode=ws_decode)
        assert (got.scheme, got.batch_axes, got.kv_axes) == (
            want.scheme, want.batch_axes, want.kv_axes), (B, S)
        assert dict(got.rules.table) == dict(want.rules.table)
        assert got.n_kv_shards == want.n_kv_shards
        # the activations' cut: "data" where it holds ranks and divides
        # d_model, under the ws plan only
        act = ("data",) if ws_decode and mshape[0] > 1 else ()
        assert got.layout.act_embed == act
    # the prefill and train plans: JAX's too, whatever ``ws_decode`` (the
    # train plan takes no scheme; tests/test_torch_launch.py covers them
    # on more meshes)
    for kind in ("prefill", "train"):
        got = plan_for(RunConfigT(model=get_config_t(name), seq_len=2048,
                                  global_batch=4, kind=kind),
                       Mesh(mshape, names), scheme=scheme,
                       ws_decode=ws_decode)
        want = jplan(JRun(model=jget(name), seq_len=2048, global_batch=4,
                          kind=kind), _jax_mesh(mshape, names),
                     scheme=scheme, ws_decode=ws_decode)
        assert (got.scheme, got.batch_axes, got.kv_axes,
                got.microbatches) == (want.scheme, want.batch_axes,
                                      want.kv_axes, want.microbatches)
        assert dict(got.rules.table) == dict(want.rules.table)
        assert got.layout.act_embed == ()


@pytest.mark.parametrize("name", PLAN_CONFIGS)
@pytest.mark.parametrize("mshape", [(1, 2), (2, 2), (1, 16), (16, 16)])
@pytest.mark.parametrize("scheme", [None, "kvp", "dp"])
def test_plan_for_matches_jax(name, mshape, scheme):
    _plans_match_jax(name, mshape, scheme, False)


@pytest.mark.parametrize("name", PLAN_CONFIGS)
@pytest.mark.parametrize("mshape", [(1, 2), (2, 2), (1, 16), (16, 16)])
@pytest.mark.parametrize("scheme", [None, "kvp", "dp"])
def test_plan_for_matches_jax_ws_decode(name, mshape, scheme):
    """``ws_decode=True``: the weight-stationary decode plan (no batch
    axes, kvp over every mesh axis, ``act_embed`` over "data") is JAX's;
    the prefill and train plans ignore the knob, as JAX's do."""
    _plans_match_jax(name, mshape, scheme, True)


LAYOUT_CASES = [
    # (config, mesh, scheme, vocab, mlp, experts, per-layer attn, kv heads)
    ("llama2-7b", (1, 2), None, True, True, False, "heads", 16),
    ("llama2-7b", (1, 2), "kvp", True, True, False, "q_heads", 32),
    ("llama2-7b", (1, 1), None, False, False, False, "whole", 32),
    ("nemotron-4-15b", (1, 2), "dp", True, True, False, "groups", 8),
    ("nemotron-4-15b", (1, 4), "dp", True, True, False, "q_heads", 8),
    # vocab 49155 stays whole on 2 ranks; the experts go over "model"
    ("granite-moe-1b-a400m", (1, 2), None, False, True, True, "heads", 4),
]


@pytest.mark.parametrize("case", LAYOUT_CASES, ids=lambda c: (
    f"{c[0]}-{c[1]}-{c[2]}"))
def test_plan_layout_is_the_one_cut_decision(case):
    """``plan_for`` decides once which weights a rank holds a piece of;
    ``shard_params`` cuts exactly those, and the pools hold
    ``layout.kv_heads`` (the model's layers read the same flags)."""
    name, mshape, scheme, vocab, mlp, experts, attn, kv_heads = case
    cfg = get_config_t(name)
    if cfg.is_moe:
        cfg = cfg.replace(moe_ep=True)
    run = RunConfigT(model=cfg, seq_len=4096, global_batch=8,
                     kind="decode")
    lay = plan_for(run, Mesh(mshape), scheme=scheme).layout
    assert (lay.vocab, lay.mlp, lay.experts, lay.kv_heads) == (
        vocab, mlp, experts, kv_heads)
    assert lay.attn == (attn,) * cfg.n_layers
    assert [lay.row_parallel(i) for i in range(cfg.n_layers)] == [
        attn != "whole"] * cfg.n_layers
    # the cut on a smoke model of the same family under the same plan
    small = cfg.smoke().replace(n_heads=cfg.n_heads // cfg.n_kv_heads * 2,
                                n_kv_heads=2, head_dim=16)
    splan = plan_for(RunConfigT(model=small, seq_len=64, global_batch=2,
                                kind="decode"), Mesh(mshape, rank=1),
                     scheme=scheme)
    from repro_torch.models.api import build_model
    model = build_model(small)
    full = model.init_params(torch.Generator().manual_seed(0))
    cut = model.shard_params(full, splan)
    m, sl = mshape[1], splan.layout
    V = small.vocab_size
    assert cut["embed"]["tok"].shape[0] == (V // m if sl.vocab else V)
    for li, (p, q) in enumerate(zip(full["layers"], cut["layers"])):
        heads = p["attn"]["wq"].shape[1]
        assert q["attn"]["wq"].shape[1] == (
            heads if sl.attn[li] == "whole" else heads // m)
        assert q["attn"]["wk"].shape[1] == p["attn"]["wk"].shape[1] // (
            m if sl.attn[li] == "heads" else 1)
        if "mlp" in p:
            assert q["mlp"]["wd"].shape[0] == p["mlp"]["wd"].shape[0] // (
                m if sl.mlp else 1)
        if "moe" in p:
            assert q["moe"]["wg"].shape[0] == p["moe"]["wg"].shape[0] // (
                m if sl.experts else 1)
            assert torch.equal(q["moe"]["router"], p["moe"]["router"])


def test_vocab_sharded_lookup_needs_a_mesh():
    """A flag the layout set, read outside the plan's mesh, is an error,
    not a silent lookup."""
    from repro_torch.errors import DistributedSetupError
    from repro_torch.models.layers import embed_tokens
    with pytest.raises(DistributedSetupError):
        embed_tokens({"tok": torch.zeros(4, 8)},
                     torch.zeros(2, dtype=torch.int32), vocab_sharded=True)


def test_shard_decode_state_refuses_other_head_counts():
    """Pools filled outside the plan (every kv head under tp) are refused,
    not cut by guessing from their shape."""
    from repro_torch.errors import EngineConfigError
    from repro_torch.models.api import build_model
    cfg = get_config_t("llama2-7b").smoke()
    run = RunConfigT(model=cfg, seq_len=32, global_batch=2, kind="decode")
    plan = plan_for(run, Mesh((1, 2)))
    assert plan.scheme == "tp" and plan.layout.kv_heads == cfg.n_kv_heads // 2
    model = build_model(cfg)
    whole = model.init_decode_state(run, device="cpu")
    with pytest.raises(EngineConfigError):
        coll.shard_decode_state(whole, plan)
    mine = model.init_decode_state(run, device="cpu", plan=plan)
    assert mine["k_pages"].shape[3] == cfg.n_kv_heads // 2
    assert coll.shard_decode_state(mine, plan)["k_pages"].shape == (
        mine["k_pages"].shape)


# ---------------------------------------------------------------------------
# kvp: page stripes, local lengths, the merge
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("P_,n", [(4, 4), (4, 2), (8, 3), (1, 4), (64, 2)])
def test_local_lens_is_the_jax_live_mask_prefix(P_, n):
    from repro.core.attention import _partial_decode
    rng = np.random.default_rng(P_ * 10 + n)
    pps = 5
    lens = np.concatenate([[0, 1, P_, n * P_, n * P_ + 1, pps * n * P_],
                           rng.integers(0, pps * n * P_ + 1, 10)]
                          ).astype(np.int32)
    B = len(lens)
    for s in range(n):
        got = coll.local_lens(torch.from_numpy(lens), P_, n, s)
        plain = coll.local_lens_plain(torch.from_numpy(lens), P_, n, s, pps)
        assert torch.equal(got, plain)
        live = coll.stripe_live(torch.from_numpy(lens), P_, n, s, pps)
        prefix = torch.arange(pps * P_)[None, :] < got[:, None]
        assert torch.equal(live, prefix)
        # the JAX partials' mass with q = k = 0 and v = 1 is the live count
        tables = np.arange(B * pps, dtype=np.int32).reshape(B, pps)
        zeros = jnp.zeros((B * pps, P_, 1, 8))
        _, l, _ = _partial_decode(jnp.zeros((B, 1, 8)), zeros,
                                  jnp.ones((B * pps, P_, 1, 8)),
                                  jnp.asarray(tables), jnp.asarray(lens),
                                  page_stride=n, page_offset=s)
        assert np.array_equal(np.asarray(l)[:, 0], got.numpy())


KVP_CASES = {  # name: lens of the two rows (page 4, 8 pages, 4 stripes)
    "jax": [29, 17],
    "short": [3, 1],  # shorter than n·P: stripes without a live page
    "empty_stripe": [12, 9],  # three pages: the fourth stripe is dead
    "full": [32, 32],
}


def _kvp_inputs():
    B, Hkv, G, D, ps, pps = 2, 2, 4, 16, 4, 8
    rng = np.random.default_rng(0)
    cases = {}
    for name, lens in KVP_CASES.items():
        cases[name] = dict(
            q4=rng.standard_normal((B, Hkv, G, D)).astype(np.float32),
            kp=rng.standard_normal((B * pps, ps, Hkv, D)).astype(np.float32),
            vp=rng.standard_normal((B * pps, ps, Hkv, D)).astype(np.float32),
            lens=np.asarray(lens, np.int32),
            logical=rng.permutation(B * pps).astype(np.int32).reshape(B, pps))
    return cases


_JAX_KVP = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.experimental.pallas import tpu as pltpu
pltpu.TPUCompilerParams = pltpu.CompilerParams  # the tests' alias
from repro.core.attention import decode_attention
from repro.distributed.collectives import decode_attention_sharded
from repro.distributed.sharding import use_mesh, DEFAULT_RULES
cases = pickle.load(open({inp!r}, "rb"))
mesh = jax.make_mesh((2, 4), ("data", "model"))
rules = DEFAULT_RULES.extend(batch=("data",))
out = {{}}
n_sh = 4
for name, c in cases.items():
    B, pps = c["logical"].shape
    q4, kp, vp, lens = (jnp.asarray(c[k]) for k in ("q4", "kp", "vp", "lens"))
    Hkv, G, D = q4.shape[1:]
    out[name + "/local"] = np.asarray(decode_attention(
        q4.reshape(B, Hkv * G, D), kp, vp, jnp.asarray(c["logical"]), lens,
        impl="ref").reshape(B, Hkv, G, D))
    # shard (d, s) holds row d's logical pages j*4+s at local slot j
    order = [int(c["logical"][d, j * n_sh + s]) for d in range(B)
             for s in range(n_sh) for j in range(pps // n_sh)]
    kp2, vp2 = kp[jnp.asarray(order)], vp[jnp.asarray(order)]
    tables = jnp.tile(jnp.arange(pps // n_sh, dtype=jnp.int32)[None, None],
                      (B, n_sh, 1))
    for mode in ("pallas", "jnp"):
        with use_mesh(mesh, rules):
            o = jax.jit(lambda q4, kp, vp, t, l: decode_attention_sharded(
                q4, kp, vp, t, l, scheme="kvp", batch_axes=("data",),
                impl="ref", combine_mode=mode))(q4, kp2, vp2, tables, lens)
        out[name + "/" + mode] = np.asarray(o)
pickle.dump(out, open({outp!r}, "wb"))
"""


@pytest.fixture(scope="module")
def kvp_refs(tmp_path_factory):
    import pickle
    tmp = tmp_path_factory.mktemp("kvp_jax")
    cases = _kvp_inputs()
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump(cases, f)
    code = _JAX_KVP.format(src=os.path.abspath(SRC), inp=inp, outp=outp)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(outp, "rb") as f:
        return cases, pickle.load(f)


@pytest.fixture(scope="module")
def kvp_ranks(tmp_path_factory, kvp_refs):
    cases, _ = kvp_refs
    out = {}
    for mshape, ba in (((1, 4), ()), ((2, 2), ("data",))):
        tmp = tmp_path_factory.mktemp("kvp_ranks")
        out[mshape] = run_ranks(tmp, "kvp_cases",
                                {"cases": cases, "batch_axes": ba}, mshape)
    return out


def test_jax_kvp_reference_is_the_local_attention(kvp_refs):
    _, ref = kvp_refs
    for name in KVP_CASES:
        for mode in ("pallas", "jnp"):
            close(ref[f"{name}/{mode}"], ref[f"{name}/local"], ATTN_TOL)


@pytest.mark.parametrize("mshape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("name", list(KVP_CASES))
@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("mode", ["kernel", "plain"])
def test_kvp_decode_matches_jax_sharded(kvp_refs, kvp_ranks, mshape, name,
                                        impl, mode):
    """Every rank's rows (on (2, 2) batch rows over "data", stripes over
    "model"; on (1, 4) four stripes over both axes) against the JAX kvp
    function on its (2, 4) mesh, pallas and jnp merges."""
    _, ref = kvp_refs
    ranks = kvp_ranks[mshape]
    for res in ranks:
        rows = res[f"{name}/rows"]
        got = res[f"{name}/{impl}/{mode}"]
        for jmode in ("pallas", "jnp"):
            close(got, ref[f"{name}/{jmode}"][rows], ATTN_TOL)


def test_kvp_merge_of_dead_ranks_is_zero_without_a_mesh():
    """All-dead partials merge to zeros in both modes (the rule that lets
    a rank with no live page take part)."""
    m = torch.full((2, 3, 4, 2), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((2, 3, 4, 2, 8))
    for mode in ("kernel", "plain"):
        out = coll.merge_flash_partials(m, l, acc, (), combine_mode=mode)
        assert torch.equal(out, torch.zeros((2, 3, 2, 8)))


def test_resolve_combine_mode():
    assert coll.resolve_combine_mode(None, 1) == "plain"
    assert coll.resolve_combine_mode(None, 4) == "kernel"
    with pytest.raises(ValueError):
        coll.resolve_combine_mode("pallas", 4)


# ---------------------------------------------------------------------------
# tp / dp attention and the writes (2 ranks) against the JAX local functions
# ---------------------------------------------------------------------------
TP_CASES = {"g4": 4, "g3": 3}  # dp splits G = 4 over 2 ranks, keeps G = 3


def _tp_inputs():
    B, Hkv, D, ps, pps = 3, 2, 16, 4, 6
    rng = np.random.default_rng(1)
    cases = {}
    for name, G in TP_CASES.items():
        lens = np.asarray([23, 5, 17], np.int32)
        cases[name] = dict(
            q4=rng.standard_normal((B, Hkv, G, D)).astype(np.float32),
            kp=rng.standard_normal((B * pps + 2, ps, Hkv, D)).astype(
                np.float32),
            vp=rng.standard_normal((B * pps + 2, ps, Hkv, D)).astype(
                np.float32),
            tables=rng.permutation(B * pps + 2)[:B * pps].astype(
                np.int32).reshape(B, pps),
            lens=lens, pos=lens - 1,
            k_new=rng.standard_normal((B, Hkv, D)).astype(np.float32),
            v_new=rng.standard_normal((B, Hkv, D)).astype(np.float32),
            k=rng.standard_normal((B, 19, Hkv, D)).astype(np.float32),
            v=rng.standard_normal((B, 19, Hkv, D)).astype(np.float32),
            plens=np.asarray([19, 7, 12], np.int32))
    return cases


@pytest.fixture(scope="module")
def tp_ranks(tmp_path_factory):
    cases = _tp_inputs()
    res = run_ranks(tmp_path_factory.mktemp("tp_ranks"), "tp_dp_cases",
                    {"cases": cases}, (1, 2))
    return cases, res


def _jax_case(c):
    from repro.core import cache as jcache
    from repro.core.attention import decode_attention
    from repro.distributed.collectives import write_decode_sharded
    B, Hkv, G, D = c["q4"].shape
    out = {"attn": np.asarray(decode_attention(
        jnp.asarray(c["q4"]).reshape(B, Hkv * G, D), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["tables"]),
        jnp.asarray(c["lens"]), impl="ref")).reshape(B, Hkv, G, D)}
    kp, vp = write_decode_sharded(
        jnp.asarray(c["kp"]), jnp.asarray(c["vp"]),
        jnp.asarray(c["tables"])[:, None], jnp.asarray(c["pos"]),
        jnp.asarray(c["k_new"]), jnp.asarray(c["v_new"]))
    out["write_decode"] = np.stack([np.asarray(kp), np.asarray(vp)])
    kp, vp = jcache.write_layer_prefill(
        jnp.zeros_like(c["kp"]), jnp.zeros_like(c["vp"]),
        jnp.asarray(c["tables"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]),
        jnp.asarray(c["plens"]))
    out["write_prefill"] = np.stack([np.asarray(kp), np.asarray(vp)])
    return out


@pytest.mark.parametrize("name", list(TP_CASES))
@pytest.mark.parametrize("what", ["tp", "dp", "write_decode/tp",
                                  "write_decode/dp", "write_decode/kvp",
                                  "write_prefill/tp", "write_prefill/dp",
                                  "write_prefill/kvp"])
def test_tp_dp_attention_and_writes_match_jax(tp_ranks, name, what):
    cases, ranks = tp_ranks
    c = cases[name]
    ref = _jax_case(c)
    Hkv, G = c["q4"].shape[1:3]
    m = len(ranks)
    for r, res in enumerate(ranks):
        got = res[f"{name}/{what}"]
        heads = slice(r * Hkv // m, (r + 1) * Hkv // m)
        if what == "tp":
            close(got, ref["attn"][:, heads], ATTN_TOL)
        elif what == "dp":
            gs = (slice(r * G // m, (r + 1) * G // m) if G % m == 0
                  else slice(0, G))
            close(got, ref["attn"][:, :, gs], ATTN_TOL)
        elif what == "write_decode/kvp":
            pages = res[f"{name}/kvp_pages"]
            want = ref["write_decode"][:, pages]
            np.testing.assert_array_equal(got, want)
        else:
            kind, scheme = what.split("/")
            want = ref[kind]
            if scheme == "tp":
                want = want[:, :, :, heads]
            np.testing.assert_array_equal(got, want)
