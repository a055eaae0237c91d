"""The port's ``launch/`` against the JAX package, in this process.

- ``plan_for`` for train, prefill and decode equals the JAX plan (batch
  axes, scheme, kv axes, microbatches, the training attention under the
  port's name, the rule table) on meshes (1, 1), (2, 4), (16, 16) and
  (2, 16, 16) for five configs, under every ``seq_parallel`` × ``ring``;
  the JAX plans read only a mesh's names and shape, so a
  ``SimpleNamespace`` stands in for its mesh.  The ring prefill's param
  specs are JAX's (its attention whole over "model").
- The spec trees: ``train_state_shardings`` against the JAX specs
  (``repro.launch.steps.train_state_shardings`` with ``NamedSharding``
  replaced by its spec), FSDP's ``embed`` over "data" and ``wq``/``wo``
  by heads and the experts over "model" included; where the port departs
  from GSPMD by design — kv projections cut with the q heads under the
  ``"heads"`` cut — the expected spec is the JAX one under the rule that
  departure changes (the strided ``"groups"`` cut has the JAX spec:
  the spec says which dim is cut, not which heads);
  ``batch_shardings``, ``decode_state_shardings`` (equal), and the
  prefill pools (the port: the decode layout; JAX: head_dim over
  "model"); ``training.loop.state_shardings`` equals the JAX one.
- ``input_specs``, ``abstract_batch`` and ``abstract_train_state``: the
  JAX shapes and dtypes, on ``meta``.
- The microbatched step against the plain one (2e-4) and each
  microbatch's gradients against ``jax.value_and_grad`` (1e-4 · (1 +
  |g|)).
- ``launch.serve`` on the smoke config gives the JAX launcher's greedy
  tokens on its prompts with its weights; ``launch.train`` runs through
  ``plan_for`` and ``build_step``; ``make_production_mesh`` refuses a
  group of another size.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_helpers import close

from repro.configs import get_config as jget
from repro.configs.base import RunConfig as JRun
from repro.distributed.sharding import logical_spec as jspec
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.distributed.collectives import shard_decode_state
from repro_torch.distributed.sharding import P
from repro_torch.errors import (DistributedSetupError, EngineConfigError,
                                UnsupportedFeature)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import params_from_numpy
from repro_torch.models.api import build_model, input_specs
from repro_torch.training import TrainState
from repro_torch.training.loop import loss_and_grads, state_shardings
from repro_torch.utils.tree import tree_leaves, tree_map

GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
STEP_TOL = 2e-4  # params after a step, microbatched against plain

MESHES = [(1, 1), (2, 4), (16, 16), (2, 16, 16)]
CONFIGS = ["llama2-7b", "granite-8b", "llama3-405b", "olmoe-1b-7b",
           "whisper-medium"]
SHAPES = {"train": [(256, 4096), (4, 512), (6, 128)],
          "prefill": [(32, 8192), (3, 1000)],
          "decode": [(128, 32768), (1, 8192)]}
FAMILIES = ["llama2-7b", "granite-moe-1b-a400m", "llama-3.2-vision-11b",
            "recurrentgemma-9b", "xlstm-350m", "whisper-medium"]


def _names(shape):
    return ("pod", "data", "model")[-len(shape):]


def _jax_mesh(shape):
    """What the JAX plans and specs read of a mesh: names and shape."""
    return types.SimpleNamespace(axis_names=_names(shape),
                                 devices=np.empty(shape))


def _runs(name, kind, B, S):
    return (RunConfig(model=get_config(name), seq_len=S, global_batch=B,
                      kind=kind),
            JRun(model=jget(name), seq_len=S, global_batch=B, kind=kind))


def _norm(spec, sizes):
    """A spec's entries as tuples of the mesh axes larger than 1, trailing
    empties dropped: the same cut whatever the notation."""
    out = []
    for e in tuple(spec):
        axes = () if e is None else (e,) if isinstance(e, str) else tuple(e)
        out.append(tuple(a for a in axes if sizes[a] > 1))
    while out and not out[-1]:
        out.pop()
    return tuple(out)


@pytest.fixture
def jax_specs(monkeypatch):
    """The JAX spec builders with ``NamedSharding`` replaced by its spec
    (they run on a stand-in mesh without devices)."""
    import repro.distributed.sharding as jsh
    import repro.launch.steps as jsteps
    for mod in (jsh, jsteps):
        monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: spec)
    return jsteps


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_for_matches_jax(name, mshape, kind):
    """Under every ``seq_parallel`` × ``ring``: the plan's fields and
    rules are JAX's, and the layout cuts the sequence (``seq``) and runs
    the ring (``ring``) exactly where the rules put ``seq`` on a "model"
    axis of more than one rank."""
    from repro.launch.steps import plan_for as jplan
    knobs = [dict(seq_parallel=sp, ring=ring) for sp in (True, False)
             for ring in (False, True)]
    m = dict(zip(_names(mshape), mshape))["model"]
    for (B, S), kw in [(bs, kw) for bs in SHAPES[kind] for kw in knobs]:
        run, jrun = _runs(name, kind, B, S)
        got = steps.plan_for(run, Mesh(mshape, _names(mshape)), **kw)
        want = jplan(jrun, _jax_mesh(mshape), **kw)
        assert (got.batch_axes, got.scheme, got.kv_axes, got.microbatches,
                got.attn_impl, got.n_kv_shards) == (
            want.batch_axes, want.scheme, want.kv_axes, want.microbatches,
            want.attn_impl, want.n_kv_shards), (B, S, kw)
        assert dict(got.rules.table) == dict(want.rules.table), (B, S, kw)
        seq = want.rules.physical("seq") == ("model",) and m > 1
        assert (got.layout.seq, got.layout.ring) == (
            seq, seq and want.attn_impl == "ring"), (B, S, kw)
        if kind == "decode":
            assert not got.layout.seq
        # the training attention under the port's name ("jnp" is "ref")
        got = steps.plan_for(run, Mesh(mshape, _names(mshape)),
                             attn_impl="ref", microbatches=2)
        want = jplan(jrun, _jax_mesh(mshape), attn_impl="jnp",
                     microbatches=2)
        assert got.microbatches == want.microbatches
        assert {"ref": "jnp"}[got.attn_impl] == want.attn_impl


def test_microbatch_search_splits_pr24s_shape():
    """llama2-7b at B 4 x S 512 holds 4·512·32000·4 B = 262 MB of f32
    logits, above 256 MB: two microbatches on one device, one on a
    (1, 2) mesh (the vocab over "model" halves it)."""
    run, _ = _runs("llama2-7b", "train", 4, 512)
    assert steps.plan_for(run, make_local_mesh()).microbatches == 2
    assert steps.plan_for(run, Mesh((1, 2))).microbatches == 1
    assert steps.plan_for(run, Mesh((2, 1))).microbatches == 1


@pytest.mark.parametrize("mshape,attn", [
    ((1, 2), "heads"), ((1, 16), "heads"), ((1, 1), "whole")])
def test_train_layout_is_the_tensor_parallel_cut(mshape, attn):
    run, _ = _runs("llama2-7b", "train", 8, 128)
    lay = steps.plan_for(run, Mesh(mshape)).layout
    assert lay.attn == (attn,) * 32
    assert (lay.vocab, lay.mlp) == ((mshape[1] > 1,) * 2)
    # llama3-405b's 8 kv heads on 16 ranks: q-head groups (G 16)
    run, _ = _runs("llama3-405b", "train", 8, 128)
    assert set(steps.plan_for(run, Mesh((1, 16))).layout.attn) == {"groups"}


@pytest.mark.parametrize("name,kind,mshape,scheme,variant", [
    ("llama3-405b", "decode", (16, 16), "kvp", "base"),
    ("llama3-405b", "prefill", (16, 16), None, "base"),
    ("nemotron-4-340b", "decode", (16, 16), "kvp", "base"),
    ("nemotron-4-340b", "decode", (16, 16), None, "swa"),
    ("nemotron-4-340b", "train", (1, 16), None, "base"),
    ("nemotron-4-15b", "decode", (16, 16), None, "swa"),
    ("granite-8b", "decode", (16, 16), None, "base")])
def test_layout_cuts_the_q_heads_where_gspmd_does(name, kind, mshape,
                                                  scheme, variant):
    """Where the model axis divides the q heads but neither the kv heads
    nor the group — kvp, dp over a group it does not divide (the swa
    variants' windowed layers), the train plan of 340B's G 12 on 16 —
    every attention layer takes GSPMD's contiguous q heads; the FSDP
    override of the big configs puts ``embed`` on "data"."""
    from repro_torch.configs import make_run
    run = dataclasses.replace(make_run(get_config(name), {
        "train": "train_4k", "prefill": "prefill_32k",
        "decode": "decode_32k" if variant == "base" else "long_500k"}[kind],
        variant=variant), kind=kind)
    plan = steps.plan_for(run, Mesh(mshape, _names(mshape)), scheme=scheme)
    cfg = run.model
    assert plan.layout.attn == ("q_heads",) * cfg.n_layers
    assert cfg.n_kv_heads % mshape[-1] and cfg.n_heads % mshape[-1] == 0
    assert plan.layout.fsdp == (("data",) if mshape[0] > 1 else ())
    assert all(plan.layout.row_parallel(i) for i in range(cfg.n_layers))


@pytest.mark.parametrize("scheme", [None, "kvp", "dp"])
def test_prefill_layout_is_the_decode_layout(scheme):
    """The prefill plan's layout is the decode plan's of the same config
    on the same mesh, so the pools it fills are the ones
    ``shard_decode_state`` takes; it adds the sequence-parallel cut of
    the activations where "model" holds more than one rank."""
    for name in ("llama2-7b", "nemotron-4-15b"):
        for mshape in ((1, 2), (2, 2), (2, 4)):
            prun, _ = _runs(name, "prefill", 8, 1024)
            drun, _ = _runs(name, "decode", 8, 1024)
            pp = steps.plan_for(prun, Mesh(mshape), scheme=scheme)
            dp = steps.plan_for(drun, Mesh(mshape), scheme=scheme)
            assert pp.scheme == "prefill_local"
            # the weights' cut; the prefill cuts the sequence too
            assert dataclasses.replace(pp.layout, seq=False) == dp.layout
            assert pp.layout.seq == (mshape[1] > 1) and not dp.layout.seq
            assert pp.batch_axes == dp.batch_axes


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------
def _jax_layer_specs(jtree, model):
    """The JAX per-parameter specs by the port's layer index: a scanned
    group's leaf loses its leading (layers) entry."""
    unit = model.cfg.layer_pattern
    n_groups = model.cfg.n_layers // len(unit)
    out = []
    for li, code in enumerate(model.codes):
        if li < n_groups * len(unit):
            j = li % len(unit)
            tree = jax.tree_util.tree_map(
                lambda s: P(*tuple(s)[1:]), jtree["groups"][f"{j}{code}"],
                is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
        else:
            j = li - n_groups * len(unit)
            tree = jtree["rem"][f"{j}{code}"]
        out.append(tree)
    return out


def _expected_specs(model, plan, jplan_rules, mesh):
    """The JAX specs under the port's departure: per attention layer the
    kv heads cut with the q heads under ``"heads"`` (the q heads over
    "model" unless whole: GSPMD's rule); FSDP's ``embed`` and the experts
    as the JAX rules put them."""
    from repro.models.api import build_model as jb
    rules = jplan_rules
    jm = jb(model.cfg)
    jaxes = jm.param_axes()
    jshapes = jm.abstract_params()
    spec = jax.tree_util.tree_map(
        lambda a, s: jspec(a, rules, mesh, s.shape), jaxes, jshapes,
        is_leaf=lambda x: isinstance(x, tuple))
    layers = _jax_layer_specs(spec, model)
    lay = plan.layout
    for li, d in enumerate(layers):
        if "attn" not in d:
            continue
        cut = lay.attn[li]
        r = rules.extend(heads=("model",) if cut != "whole" else None,
                         kv_heads=("model",) if cut == "heads" else None)
        a = model.param_spec()["layers"][li]["attn"]
        d["attn"] = {k: jspec(s.axes, r, mesh, s.shape) for k, s in a.items()}
    out = {k: v for k, v in spec.items() if k not in ("groups", "rem")}
    out["layers"] = layers
    return out


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, (P, jax.sharding.PartitionSpec)):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves_by_path(v, f"{prefix}/{k}"))
        return out
    out = {}
    for i, v in enumerate(tree):
        out.update(_leaves_by_path(v, f"{prefix}/{i}"))
    return out


@pytest.mark.parametrize("mshape", [(1, 2), (2, 4), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("name", ["llama2-7b", "granite-8b", "llama3-405b",
                                  "olmoe-1b-7b", "granite-moe-1b-a400m",
                                  "nemotron-4-340b", "nemotron-4-15b"])
def test_train_state_specs_match_jax(name, mshape, jax_specs):
    run, jrun = _runs(name, "train", 256, 4096)
    mesh = Mesh(mshape, _names(mshape))
    plan = steps.plan_for(run, mesh)
    jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape))
    model = build_model(run.model)
    got = steps.train_state_shardings(model, plan)
    sizes = dict(zip(_names(mshape), mshape))
    want = _expected_specs(model, plan, jplan.rules, _jax_mesh(mshape))
    g, w = _leaves_by_path(got.params), _leaves_by_path(want)
    assert sorted(g) == sorted(w)
    for k in g:
        assert _norm(g[k], sizes) == _norm(w[k], sizes), k
    assert got.opt.mu is got.params and tuple(got.step) == ()
    # the departure left is real and the only one: under JAX's own rules
    # the trees differ exactly at the kv projections of "heads" layers
    # (FSDP's embed, the q heads and the experts are JAX's)
    jtree = jax_specs.train_state_shardings(jbuild(jrun.model), jplan)
    raw = _leaves_by_path({**{k: v for k, v in jtree.params.items()
                              if k not in ("groups", "rem")},
                           "layers": _jax_layer_specs(jtree.params, model)})
    differ = {k for k in g if _norm(g[k], sizes) != _norm(raw[k], sizes)}
    heads = {li for li, c in enumerate(plan.layout.attn) if c == "heads"}
    for k in differ:
        assert k.split("/")[4] in ("wk", "wv") and int(
            k.split("/")[2]) in heads, k
    fsdp = "embed" in run.model.axis_overrides and sizes["data"] > 1
    assert plan.layout.fsdp == (("data",) if fsdp else ())
    if fsdp:  # the norms too: their one dim is embed
        norms = [k for k in g if "/ln" in k]
        assert norms and all(_norm(g[k], sizes) == (("data",),)
                             for k in norms)


@pytest.mark.parametrize("mshape", [(1, 2), (2, 4), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("name", ["llama2-7b", "granite-8b", "llama3-405b",
                                  "nemotron-4-340b"])
def test_ring_prefill_param_specs_match_jax(name, mshape, jax_specs):
    """The ring prefill plan (JAX's ``heads: None, kv_heads: None``): every
    attention weight whole over "model", the layout's attention
    ``"whole"`` in every layer, and the param specs JAX's leaf for leaf
    with no departure (the vocab and ``d_ff`` over "model", FSDP's
    ``embed``); the pools keep the decode plan's kv heads."""
    run, jrun = _runs(name, "prefill", 32, 8192)
    mesh = Mesh(mshape, _names(mshape))
    plan = steps.plan_for(run, mesh, ring=True)
    jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape), ring=True)
    model = build_model(run.model)
    assert plan.attn_impl == jplan.attn_impl == "ring"
    assert plan.layout.attn == ("whole",) * run.model.n_layers
    m = mshape[-1]
    assert (plan.layout.seq, plan.layout.ring) == (m > 1, m > 1)
    got = _leaves_by_path(steps.param_specs(model, plan))
    jtree = jax_specs._param_shardings(jbuild(jrun.model), jplan,
                                       jnp.bfloat16)
    want = _leaves_by_path({**{k: v for k, v in jtree.items()
                               if k not in ("groups", "rem")},
                            "layers": _jax_layer_specs(jtree, model)})
    sizes = dict(zip(_names(mshape), mshape))
    assert sorted(got) == sorted(want)
    for k in got:
        assert _norm(got[k], sizes) == _norm(want[k], sizes), k
        if "/attn/" in k:
            assert "model" not in [a for e in _norm(got[k], sizes)
                                   for a in e], k
    dplan = steps.plan_for(dataclasses.replace(run, kind="decode"), mesh)
    assert plan.layout.kv_heads == dplan.layout.kv_heads


@pytest.mark.parametrize("mshape", [(1, 2), (2, 4), (2, 16, 16)])
def test_loop_state_shardings_match_jax(mshape, jax_specs):
    """``training.loop.state_shardings``: the specs of the cut
    ``shard_params`` makes under a rule table — the JAX parameter specs
    of ``repro.training.loop.state_shardings`` (``make_param_shardings``),
    leaf for leaf (the JAX tree stacks the layers: its leading entry
    goes)."""
    from repro.distributed.sharding import DEFAULT_RULES as JR
    from repro_torch.distributed.sharding import DEFAULT_RULES
    over = {"embed": ("data",)}
    mesh = Mesh(mshape, _names(mshape))
    sizes = dict(zip(_names(mshape), mshape))
    for name in ("llama2-7b", "granite-8b"):
        model = build_model(get_config(name))
        got = state_shardings(model, mesh, DEFAULT_RULES.extend(**over))
        want = _jax_state_params(jbuild(jget(name)), model,
                                 JR.extend(**over), _jax_mesh(mshape))
        g, w = _leaves_by_path(got.params), _leaves_by_path(want)
        assert sorted(g) == sorted(w)
        for k in g:
            assert _norm(g[k], sizes) == _norm(w[k], sizes), k
        assert tuple(got.opt.count) == () and got.opt.nu is got.params


def _jax_state_params(jm, model, rules, mesh):
    from repro.distributed.sharding import make_param_shardings
    tree = make_param_shardings(mesh, rules, jm.param_axes(),
                                jm.abstract_params())
    out = {k: v for k, v in tree.items() if k not in ("groups", "rem")}
    out["layers"] = _jax_layer_specs(tree, model)
    return out


@pytest.mark.parametrize("mshape", MESHES)
@pytest.mark.parametrize("name", ["llama2-7b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_batch_specs_match_jax(name, mshape, jax_specs):
    for B in (256, 6):
        run, jrun = _runs(name, "train", B, 128)
        plan = steps.plan_for(run, Mesh(mshape, _names(mshape)))
        jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape))
        got = steps.batch_shardings(run, plan)
        want = jax_specs.batch_shardings(jrun, jplan)
        assert set(got) == set(want)
        sizes = dict(zip(_names(mshape), mshape))
        for k in got:
            assert _norm(got[k], sizes) == _norm(want[k], sizes), (k, B)


@pytest.mark.parametrize("scheme", [None, "kvp", "dp"])
@pytest.mark.parametrize("mshape", [(1, 2), (2, 4), (16, 16), (2, 16, 16)])
@pytest.mark.parametrize("name", ["llama2-7b", "llama3-405b",
                                  "nemotron-4-15b"])
def test_decode_state_specs_match_jax(name, mshape, scheme, jax_specs):
    """Decode: the JAX specs, key for key.  Prefill: the pools follow the
    decode layout (kv heads over "model" under tp) where the JAX prefill
    cuts head_dim over "model": the named departure."""
    sizes = dict(zip(_names(mshape), mshape))
    for kind in ("decode", "prefill"):
        run, jrun = _runs(name, kind, 32, 8192)
        plan = steps.plan_for(run, Mesh(mshape, _names(mshape)),
                              scheme=scheme)
        jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape), scheme=scheme)
        model, jm = build_model(run.model), jbuild(jrun.model)
        state = steps._abstract_state(model, run, plan, torch.bfloat16)
        jstate = jm.init_decode_state(jrun, jnp.bfloat16,
                                      n_kv_shards=jplan.n_kv_shards,
                                      abstract=True)
        assert {k: tuple(v.shape) for k, v in state.items()} == {
            k: tuple(v.shape) for k, v in jstate.items()}
        got = steps.decode_state_shardings(model, plan, state)
        want = jax_specs.decode_state_shardings(jm, jplan, jstate)
        assert set(got) == set(want)
        for k in got:
            if kind == "prefill" and k in ("k_pages", "v_pages"):
                dplan = steps.plan_for(
                    RunConfig(model=run.model, seq_len=8192, global_batch=32,
                              kind="decode"),
                    Mesh(mshape, _names(mshape)), scheme=scheme)
                tp = dplan.scheme == "tp" and sizes["model"] > 1
                assert _norm(got[k], sizes)[3:4] == ((("model",),) if tp
                                                     else ())
                assert len(_norm(want[k], sizes)) in (2, 5)
                continue
            assert _norm(got[k], sizes) == _norm(want[k], sizes), (kind, k)


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", FAMILIES)
def test_input_specs_match_jax(name, kind):
    from repro.models.api import input_specs as jinput
    run, jrun = _runs(name, kind, 4, 96)
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        got, want = input_specs(run, dtype), jinput(jrun, jdtype)
        assert set(got) == set(want)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), k
            assert str(v.dtype).split(".")[1] == str(want[k].dtype), k


@pytest.mark.parametrize("name", ["llama2-7b", "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_abstract_batch_and_train_state_match_jax(name):
    from repro.launch.steps import abstract_batch as jab
    from repro.launch.steps import abstract_train_state as jats
    run, jrun = _runs(name, "train", 8, 64)
    got, want = steps.abstract_batch(run), jab(jrun)
    assert {k: (tuple(v.shape), v.device.type) for k, v in got.items()} == {
        k: (tuple(v.shape), "meta") for k, v in want.items()}
    cfg = get_config(name).smoke()
    model, jm = build_model(cfg), jbuild(jget(name).smoke())
    st = steps.abstract_train_state(model, torch.bfloat16, torch.float32)
    jst = jats(jm, jnp.bfloat16, jnp.float32)
    g = [tuple(x.shape) for x in tree_leaves(st.params)]
    w = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jst.params)]
    assert sum(map(np.prod, g)) == sum(map(np.prod, w))
    assert {x.dtype for x in tree_leaves(st.params)} == {torch.bfloat16}
    assert {x.dtype for x in tree_leaves(st.opt.mu)} == {torch.float32}
    assert all(x.device.type == "meta" for x in tree_leaves(st))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_step_returns_the_4_tuple(kind):
    cfg = get_config("llama2-7b").smoke()
    run = RunConfig(model=cfg, seq_len=32, global_batch=4, kind=kind)
    plan = steps.plan_for(run, make_local_mesh(), attn_impl="ref")
    step, args, specs, model = steps.build_step(run, plan, torch.float32)
    assert callable(step) and model.cfg is cfg
    assert set(args) == set(specs)
    assert all(x.device.type == "meta" for x in tree_leaves(args))


# ---------------------------------------------------------------------------
# the microbatched step
# ---------------------------------------------------------------------------
def _jax_grads(jm, jp, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: jm.loss_fn(p, jb), has_aux=True))(jp)
    return float(loss), jax.tree_util.tree_map(np.asarray, g)


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatched_step_matches_plain_and_jax(mb):
    """Each microbatch's gradients equal ``jax.value_and_grad`` on it;
    their mean is ``train_grads``'; two microbatched steps land within
    2e-4 of two plain ones (AdamW's first step is near lr · sign(g))."""
    from repro.data import synthetic_batches as jbatches
    name = "llama2-7b"
    cfg, jcfg = get_config(name).smoke(), jget(name).smoke()
    jm = jbuild(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    full = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    batch = next(jbatches(8, 32, cfg.vocab_size, seed=1, cfg=jcfg))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    run = RunConfig(model=cfg, seq_len=32, global_batch=8, kind="train")
    mesh = make_local_mesh()
    plan = steps.plan_for(run, mesh, attn_impl="ref", microbatches=mb)
    plain = steps.plan_for(run, mesh, attn_impl="ref", microbatches=1)
    model = build_model(cfg)
    b = 8 // mb
    jg_mean = None
    for i in range(mb):
        sub = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
        jl, jg = _jax_grads(jm, jp, sub)
        tl, _, tg = loss_and_grads(
            model, full, {k: torch.from_numpy(np.asarray(v))
                          for k, v in sub.items()}, "ref")
        assert abs(float(tl) - jl) <= 1e-5 * abs(jl)
        want = params_from_numpy(jg, "cpu")
        for g, w in zip(tree_leaves(tg), tree_leaves(want)):
            assert float(((g - w).abs() / (1 + w.abs())).max()) <= GRAD_TOL
        jg_mean = jg if jg_mean is None else jax.tree_util.tree_map(
            np.add, jg_mean, jg)
    _, _, acc = steps.train_grads(model, plan)(full, tb)
    want = params_from_numpy(jax.tree_util.tree_map(
        lambda g: g / mb, jg_mean), "cpu")
    for g, w in zip(tree_leaves(acc), tree_leaves(want)):
        assert g.dtype == torch.float32
        assert float(((g - w).abs() / (1 + w.abs())).max()) <= GRAD_TOL
    step = steps.build_train_step(run, plan, torch.float32)[0]
    step1 = steps.build_train_step(run, plain, torch.float32)[0]
    # each step donates its state (AdamW in place): one copy each
    a, b_ = (TrainState.create(tree_map(torch.clone, full)) for _ in "ab")
    for _ in range(2):
        a, ma = step(a, tb)
        b_, mb_ = step1(b_, tb)
        for x, y in zip(tree_leaves(a.params), tree_leaves(b_.params)):
            close(x.numpy(), y.numpy(), STEP_TOL)
        assert abs(float(ma["loss"]) - float(mb_["loss"])) <= 1e-5


def test_train_step_takes_the_given_rate():
    """``lr`` passes through (the JAX builder fixes 3e-4, and the JAX
    launcher ignores ``--lr``); 3e-4 by default."""
    cfg = get_config("llama2-7b").smoke()
    run = RunConfig(model=cfg, seq_len=16, global_batch=2, kind="train")
    plan = steps.plan_for(run, make_local_mesh(), attn_impl="ref")
    model = build_model(cfg)
    full = model.init_params(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, 512, (2, 16), generator=g)
             for k in ("inputs", "targets")}
    moved = {}
    for lr in (3e-4, 1e-3, None):
        kw = {} if lr is None else {"lr": lr}
        st, _ = steps.build_train_step(run, plan, torch.float32, **kw)[0](
            TrainState.create(tree_map(torch.clone, full)), batch)
        moved[lr] = float((st.params["ln_f"]["scale"]
                           - full["ln_f"]["scale"]).abs().max())
    assert moved[None] == moved[3e-4] < moved[1e-3]


@pytest.mark.parametrize("name", ["xlstm-350m", "whisper-medium",
                                  "llama-3.2-vision-11b"])
def test_prefill_and_serve_steps_refuse_undistributed_state(name):
    cfg = get_config(name).smoke()
    for kind, build in (("prefill", steps.build_prefill_step),
                        ("decode", steps.build_serve_step)):
        run = RunConfig(model=cfg, seq_len=32, global_batch=2, kind=kind)
        plan = steps.plan_for(run, make_local_mesh())
        with pytest.raises(UnsupportedFeature):
            build(run, plan)


def test_shard_decode_state_takes_the_rank_s_rows():
    """A state of the whole batch under a plan with batch axes is refused:
    ``build_prefill_step`` fills each rank's rows."""
    cfg = get_config("llama2-7b").smoke()
    run = RunConfig(model=cfg, seq_len=32, global_batch=4, kind="decode")
    model = build_model(cfg)
    for mshape, rows, ok in (((2, 1), 2, True), ((2, 1), 4, False),
                             ((1, 2), 4, True)):
        plan = steps.plan_for(run, Mesh(mshape, rank=1))
        lrun = RunConfig(model=cfg, seq_len=32, global_batch=rows,
                         kind="decode")
        st = model.init_decode_state(lrun, device="cpu", plan=plan)
        if ok:
            out = shard_decode_state(st, plan)
            assert out["pos"].shape == (rows,)
        else:
            with pytest.raises(EngineConfigError, match="rows"):
                shard_decode_state(st, plan)


# ---------------------------------------------------------------------------
# mesh and launchers
# ---------------------------------------------------------------------------
def test_h100_constants():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12 and tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 900e9


def test_make_production_mesh_refuses_a_group_of_another_size(tmp_path):
    import torch.distributed as dist
    with pytest.raises(DistributedSetupError, match="init_process_group"):
        tmesh.make_production_mesh()
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(DistributedSetupError, match="256 ranks"):
            tmesh.make_production_mesh()
        with pytest.raises(DistributedSetupError, match="512 ranks"):
            tmesh.make_production_mesh(multi_pod=True)
    finally:
        dist.destroy_process_group()


def test_serve_cli_gives_the_jax_launcher_s_tokens(monkeypatch, capsys):
    """The JAX launcher (its ``Engine`` recorded) and the port's on the
    same arguments: the same prompts, and with the JAX weights the same
    greedy tokens, steps, preemptions and pool."""
    import repro.launch.serve as jserve
    from repro_torch.launch import serve
    argv = ["--arch", "llama2-7b", "--smoke", "--requests", "5",
            "--max-new", "6", "--max-slots", "2", "--max-seq-len", "64",
            "--pool-tokens", "48"]
    seen = {}

    class Recorded(jserve.Engine):
        def generate(self, reqs, **kw):
            seen["engine"], seen["reqs"] = self, reqs
            return super().generate(reqs, **kw)

    monkeypatch.setattr(jserve, "Engine", Recorded)
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    jserve.main()
    jout = capsys.readouterr().out
    jeng, jreqs = seen["engine"], seen["reqs"]
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                      jeng.params), "cpu")
    args = serve.parse_args(argv + ["--device", "cpu"])
    eng, reqs, report = serve.serve(
        get_config("llama2-7b").smoke(), params, requests=args.requests,
        max_new=args.max_new, max_slots=args.max_slots,
        max_seq_len=args.max_seq_len, pool_tokens=args.pool_tokens,
        paged=not args.no_paged, device=args.device)
    out = capsys.readouterr().out
    assert [r.prompt for r in reqs] == [r.prompt for r in jreqs]
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert all(len(r.output) == 6 for r in reqs)
    assert eng.steps == jeng.steps
    assert eng.scheduler.preempted == jeng.scheduler.preempted > 0
    assert report["pool_mib"] == jeng.memory_report()["pool_bytes"] / 2**20
    for line in ("tokens in", "engine steps:", "kv pool", "ttft"):
        assert line in out and line in jout


def test_serve_cli_on_the_baseline_and_the_card_default():
    from repro_torch.launch import serve
    eng, reqs, report = serve.main(
        ["--arch", "llama2-7b", "--smoke", "--requests", "3", "--max-new",
         "4", "--max-seq-len", "40", "--no-paged", "--device", "cpu"])
    assert not eng.paged and all(len(r.output) == 4 for r in reqs)
    assert report["steps"] == eng.steps and report["tokens"] == 12
    with pytest.raises(EngineConfigError, match="no CUDA device"):
        serve.main(["--arch", "llama2-7b", "--smoke", "--requests", "1"])


def test_train_cli_runs_through_the_plan(monkeypatch):
    from repro_torch.launch import train as launch_train
    seen = []
    real_plan, real_build = launch_train.plan_for, launch_train.build_step

    def plan_for(run, mesh, **kw):
        plan = real_plan(run, mesh, **kw)
        seen.append(plan)
        return plan

    def build_step(run, plan, *a, **kw):
        seen.append(kw)
        return real_build(run, plan, *a, **kw)

    monkeypatch.setattr(launch_train, "plan_for", plan_for)
    monkeypatch.setattr(launch_train, "build_step", build_step)
    state, hist = launch_train.main(
        ["--arch", "llama2-7b", "--smoke", "--steps", "2", "--batch", "4",
         "--seq", "16", "--lr", "1e-3", "--log-every", "1", "--device",
         "cpu"])
    plan, kw = seen
    assert plan.run.kind == "train" and plan.attn_impl == "ref"
    assert plan.mesh.shape == (1, 1) and kw == {"lr": 1e-3}
    assert [h["step"] for h in hist] == [1, 2]
    assert launch_train.parse_args(["--arch", "x"]).production_mesh is False
