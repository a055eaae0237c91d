"""The dry run (``launch.dryrun``, ``launch.cost_analysis``,
``launch.steps.dry_step``) against the real step and the JAX package, on
the CPU at smoke size.

- Dry against real: one ``gloo`` group of 4 CPU processes
  (``_torch_dist.dryrun_cases``) runs train and decode under
  ``impl="ref"`` on meshes (1, 1), (2, 1), (1, 2) and (2, 2), prefill on
  (1, 1) and (2, 2), kvp decode on (2, 2), and the smoke granite-8b
  under FSDP (its ``embed: ("data",)`` override: the weights' gathers,
  the gradients' reduce-scatters, the in-place AdamW) in train on (2, 1)
  and (2, 2), prefill on (2, 2) and kvp decode (``"q_heads"``) on (2, 2),
  and its weight-stationary decode (``ws_decode``) on (2, 1) and under
  kvp on (2, 2), each rank once for real on CPU tensors
  (``cost_analysis.record_step``) and once dry (``dry_step`` on a dry
  mesh of the same shape and rank):
  FLOPs equal exactly, the collectives' calls and bytes per op equal
  the real mesh's ``stats`` exactly, and the dry peak is within
  ``PEAK_TOL`` of the real one and never below it.
- At the production size: llama3-405b's decode_32k on (16, 16) fits
  (``"q_heads"`` and FSDP), the reduce-scatter bytes of an FSDP
  train step are counted, and granite-8b's decode_32k pair with and
  without ``--ws-decode``: the ws pair gathers no weight over "data",
  and its all-reduces over "data" are the partials counted from the
  shapes; recurrentgemma-9b's ``decode_32k`` (one ``RRW`` unit) and
  ``train_4k`` (one layer) trace with the RG-LRU gates' reduce-scatter.
- Against JAX: ``count_params``/``param_bytes`` on every config's
  parameters, ``model_flops`` for every config and kind, ``collective_
  bytes`` per kind on HLO lines of the same shapes and groups,
  ``make_run_for``/``SKIPS``/``SWA_FOR_LONG`` for every (arch, shape),
  and ``plan_for(..., zero_pod=True)`` on the stand-in meshes of
  ``tests/test_torch_launch.py``.
- ``zero_pod``: 2 ranks on a (2, 1, 1) ("pod", "data", "model") mesh, 2
  steps of the smoke llama2-7b: params equal the plain plan's (1e-6) and
  the JAX single-device step's (``STEP_TOL``, the (2, 1) case's), and each
  rank holds half of every moment cut along ``embed``.
- The kernels' stand-ins: K1, K2 (three routes), K3 and K4 in dry mode
  give their plain versions' shapes and dtypes and count under
  ``launch_counts()`` keys; in dry mode each wrapper still refuses what
  the card refuses; outside dry mode ``use_kernel`` still refuses a meta
  tensor, and real CPU tensors never stand in.
- The CLI writes its JSON, records a refused pair as "unsupported" (the
  VLM's ``C`` layers, xLSTM, the encoder–decoder), and
  the production meshes and H100 constants.
"""

import functools
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_helpers import close

from repro.configs import get_config as jget
from repro.configs.base import RunConfig as JRun
from repro.launch import hlo_analysis as jha
from repro.models.api import build_model as jbuild
from repro_torch import kernels
from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config
from repro_torch.configs.base import RunConfig
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun, mesh as tmesh, steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params_from_numpy
from repro_torch.models.api import build_model
from repro_torch.models import spec as pspec
from repro_torch.utils import count_params, param_bytes
from repro_torch.utils.tree import tree_map_with_path_names, tree_paths

PEAK_TOL = 0.01  # dry peak within 1 % of the real CPU step's, never below
STEP_TOL = 2e-4  # params after 2 steps against the JAX step (the (2, 1) case)
ZERO_TOL = 1e-6  # the ZeRO-1 step against the plain step, same ranks
B, S = 4, 64
ARCHS = ASSIGNED + ["llama2-7b"]
# name: (mesh shape, kind, decode scheme asked for); train and decode on
# every mesh, prefill alone and on (2, 2) (its data and model cuts at once)
CASES = {f"{kind} {shape}": (shape, kind, None, "llama2-7b")
         for shape in ((1, 1), (2, 1), (1, 2), (2, 2))
         for kind in ("train", "prefill", "decode")
         if kind != "prefill" or shape in ((1, 1), (2, 2))}
CASES["decode (2, 2) kvp"] = ((2, 2), "decode", "kvp", "llama2-7b")
# FSDP: granite-8b carries the embed: ("data",) override
CASES.update({"fsdp train (2, 1)": ((2, 1), "train", None, "granite-8b"),
              "fsdp train (2, 2)": ((2, 2), "train", None, "granite-8b"),
              "fsdp prefill (2, 2)": ((2, 2), "prefill", None,
                                      "granite-8b"),
              "fsdp decode (2, 2) kvp": ((2, 2), "decode", "kvp",
                                         "granite-8b"),
              # weight-stationary decode: every row on every rank, the
              # activations cut along embed over "data"
              "fsdp ws decode (2, 1)": ((2, 1), "decode", None,
                                        "granite-8b", {},
                                        {"ws_decode": True}),
              "fsdp ws decode (2, 2) kvp": ((2, 2), "decode", "kvp",
                                            "granite-8b", {},
                                            {"ws_decode": True})})


def _jax_dryrun():
    """The JAX ``launch.dryrun`` module; its import sets ``XLA_FLAGS`` for
    512 host devices, which is put back at once (the backend is created
    later, by whichever test needs it)."""
    prev = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as jdry
    if prev is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = prev
    return jdry


# ---------------------------------------------------------------------------
# dry against real, on gloo ranks
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("dryrun"), "dryrun_cases",
                     {"cases": CASES, "B": B, "S": S}, (2, 2), timeout=600)


@pytest.mark.parametrize("name", list(CASES))
def test_dry_flops_equal_the_real_step(ranks, name):
    for r in ranks:
        got = r[name]
        assert got["dry"]["flops"] == got["real"]["flops"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_dry_collectives_equal_the_real_mesh_stats(ranks, name):
    shape = CASES[name][0]
    for r in ranks:
        got = r[name]
        assert got["dry"]["calls"] == got["real"]["calls"]
        assert got["dry"]["coll_bytes"] == got["real"]["coll_bytes"]
        kind, config = CASES[name][1], CASES[name][3]
        assert bool(got["real"]["calls"]) == (
            shape[1] > 1 or (kind == "train" and shape[0] > 1)
            or (config == "granite-8b" and shape[0] > 1))
        if config == "granite-8b" and " ws " in name:
            # no weight gathered: on (2, 2) each layer's kvp merge (over
            # "data" and "model" at once) and "q_heads" gather (over
            # "model"), and the logits' vocab gather
            assert got["real"]["calls"].get("all_gather", 0) == (
                2 * get_config(config).smoke().n_layers + 1
                if shape[1] > 1 else 0)
            assert got["real"]["calls"]["all_reduce"] > 0
        elif config == "granite-8b":  # FSDP: the gathers, the grads' scatter
            assert got["real"]["calls"]["all_gather"] > 0
            # beside the activations' reduce-scatters of a sequence-
            # parallel plan: the lookup's and each layer's two row-
            # parallel outputs'
            rs = got["real"]["calls"].get("reduce_scatter", 0)
            seq = (2 * get_config(config).smoke().n_layers + 1
                   if got["seq"] else 0)
            assert rs > seq if kind == "train" else rs == seq


@pytest.mark.parametrize("name", list(CASES))
def test_dry_peak_bounds_the_real_peak(ranks, name):
    for r in ranks:
        dry, real = (r[name][k]["memory"] for k in ("dry", "real"))
        assert real["peak_bytes"] <= dry["peak_bytes"] <= (
            (1 + PEAK_TOL) * real["peak_bytes"]), (dry, real)
        assert dry["argument_bytes"] == real["argument_bytes"]


def test_dry_cases_take_their_schemes(ranks):
    for r in ranks:
        assert r["decode (2, 2) kvp"]["scheme"] == "kvp"
        assert r["decode (1, 2)"]["scheme"] == "tp"
        # under impl="ref" no kernel wrapper runs but kvp's merge (K2)
        assert r["decode (1, 2)"]["dry"]["kernels"] == {}
        assert r["decode (2, 2) kvp"]["dry"]["kernels"] == {
            "combine": 2, "combine/dist": 2}


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_count_params_and_param_bytes_match_jax(name):
    from repro.utils.tree import count_params as jcount
    from repro.utils.tree import param_bytes as jbytes
    jtree = jbuild(jget(name)).abstract_params(jnp.bfloat16)
    spec = build_model(get_config(name)).param_spec()
    got = pspec.abstract(spec, torch.bfloat16)
    assert count_params(got) == count_params(spec) == jcount(jtree)
    assert param_bytes(got) == jbytes(jtree)
    assert param_bytes(spec) == 0  # a ParamSpec has no dtype


def test_tree_map_with_path_names():
    tree = {"b": [torch.zeros(2), torch.ones(3)], "a": torch.zeros(1)}
    got = tree_map_with_path_names(lambda n, x: (n, x.numel()), tree)
    assert got == {"a": ("a", 1), "b": [("b/0", 2), ("b/1", 3)]}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", ARCHS)
def test_model_flops_match_jax(name, kind):
    assert ca.model_flops(get_config(name), 1000, kind) == (
        jha.model_flops(jget(name), 1000, kind))


def _hlo(kind, dtype, out_shape, group):
    dims = ",".join(map(str, out_shape))
    groups = ",".join(map(str, group))
    return (f"  %x = {dtype}[{dims}]{{1,0}} {kind}(%y), "
            f"replica_groups={{{{{groups}}}}}")


@pytest.mark.parametrize("kind,op", [("all-gather", "all_gather"),
                                     ("all-reduce", "all_reduce"),
                                     ("reduce-scatter", "reduce_scatter"),
                                     ("all-to-all", "all_to_all"),
                                     ("collective-permute", "send_recv")])
@pytest.mark.parametrize("group", [(0, 1), (0, 1, 2, 3), tuple(range(16))])
def test_collective_bytes_match_jax(kind, op, group):
    """Each kind against the JAX count of an HLO line of the same output
    and group.  A reduce-scatter sends ``in − out`` (JAX's stated ring
    factor): its input is g outputs, where JAX's sum takes (g−1)/g of the
    output's bytes alone, g times less."""
    g = len(group)
    out_shape, dtype, item = (8 * g, 128), "bf16", 2
    out_bytes = 8 * g * 128 * item
    sent = (out_bytes // g if op == "all_gather"
            else out_bytes * g if op == "reduce_scatter" else out_bytes)
    got = ca.collective_bytes({"ops": [(op, sent, g, group)]})
    want = jha.collective_bytes(_hlo(kind, dtype, out_shape, group))
    scale = g if op == "reduce_scatter" else 1
    for k in want:
        assert got[k] == pytest.approx(want[k] * scale), k
    if op == "reduce_scatter":
        assert got[kind] == sent - out_bytes
    assert got["within_node"] == (got["total"] if g <= 8 else 0.0)
    assert got["beyond_node"] == (got["total"] if g > 8 else 0.0)


def test_405b_decode_fits_under_q_heads_and_fsdp():
    """llama3-405b's decode_32k at its real size on rank 0 of (16, 16):
    the q heads cut over "model" (kvp) and the weights over "data" bring
    the rank under 80 GB (PR 27, everything but the vocab, ``d_ff`` and
    the pools whole on every rank: 194.0 GB)."""
    res = dryrun.run_pair("llama3-405b", "decode_32k", False)
    assert res["status"] == "ok" and res["plan"]["attn"] == ["q_heads"]
    assert res["plan"]["rules"]["embed"] == ("data",)
    assert res["fits"] and res["memory"]["peak_bytes"] < 20e9
    assert res["collective_calls"]["all_gather"] > 0


def test_ws_decode_pair_gathers_no_weight():
    """granite-8b's decode_32k pair at its real size on rank 0 of (16,
    16), with and without ``--ws-decode``: the plain pair all-gathers
    FSDP's weights over "data" every layer, the ws pair none; the ws
    pair's all-reduces over "data" are exactly the f32 partials of its
    layers — per layer the two norms' sums (B, 1), q/k/v packed (B, (H/m
    + 2 Hkv) hd) (kvp's ``"q_heads"``: H/m q heads, every kv head) and
    the MLP's ``wg``/``wu`` (B, 2 d_ff/m); then the final norm's and the
    logits' (B, V/m) — in every row (no batch axes)."""
    cfg = get_config("granite-8b")
    plain = dryrun.run_pair("granite-8b", "decode_32k", False)
    ws = dryrun.run_pair("granite-8b", "decode_32k", False, ws_decode=True)
    assert plain["status"] == ws["status"] == "ok"
    assert plain["plan"]["scheme"] == ws["plan"]["scheme"] == "kvp"
    assert plain["plan"]["attn"] == ws["plan"]["attn"] == ["q_heads"]
    assert ws["plan"]["ws"]["batch_axes"] == ()
    assert ws["plan"]["ws"]["kv_axes"] == ("data", "model")
    assert ws["plan"]["ws"]["act_embed"] == ("data",)
    assert plain["collectives_by_axes"]["data"]["all-gather"]["bytes"] > 0
    assert "all-gather" not in ws["collectives_by_axes"].get("data", {})
    B, m = 128, 16
    hd = cfg.resolved_head_dim
    per_layer = 1 + (cfg.n_heads // m + 2 * cfg.n_kv_heads) * hd + 1 + (
        2 * cfg.d_ff // m)
    n = cfg.n_layers * per_layer + 1 + cfg.vocab_size // m
    got = ws["collectives_by_axes"]["data"]["all-reduce"]
    assert got["bytes"] == B * n * 4
    assert got["calls"] == 4 * cfg.n_layers + 2


def test_fsdp_train_counts_reduce_scatter_bytes():
    """An FSDP train step traced dry (granite-8b at 1 layer, production
    widths, B 16 x S 256 on a (2, 2) dry mesh): one reduce-scatter per
    cut leaf per microbatch, and their bytes in ``collective_bytes``,
    (g − 1)/g of what each sends."""
    from repro_torch.launch.mesh import make_dry_mesh
    cfg = get_config("granite-8b").replace(n_layers=1)
    run = RunConfig(model=cfg, seq_len=256, global_batch=16, kind="train")
    plan = steps.plan_for(run, make_dry_mesh((2, 2)), attn_impl="ref",
                          microbatches=2)
    rec = steps.dry_step(run, plan, torch.bfloat16)
    n_cut = sum(steps._cuts(s, "data")
                for s in steps.spec_leaves(steps.param_specs(
                    build_model(cfg), plan)))
    # the tied table is gathered twice a microbatch (lookup and head);
    # over "model" (ranks 0 and 1 of the dry mesh) the sequence-parallel
    # plan reduce-scatters, a microbatch, the lookup and the layer's two
    # row-parallel outputs, and in the backward the gradients of the
    # sequence gathered before the layer's two column-parallel products
    # and the head
    groups = [ranks for op, _, _, ranks in rec.stats["ops"]
              if op == "reduce_scatter"]
    assert groups.count((0, 2)) == 2 * (n_cut + 1)
    assert groups.count((0, 1)) == 2 * (3 + 3) and plan.layout.seq
    assert rec.stats["calls"]["reduce_scatter"] == len(groups)
    sent = sum(n / 2 for op, n, g, _ in rec.stats["ops"]
               if op == "reduce_scatter")
    got = ca.collective_bytes(rec.stats)
    assert got["reduce-scatter"] == sent > 0


@pytest.mark.parametrize("shape", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", ARCHS)
def test_make_run_for_matches_jax(name, shape):
    jdry = _jax_dryrun()
    got, want = dryrun.make_run_for(name, shape), jdry.make_run_for(name,
                                                                    shape)
    assert (got is None) == (want is None)
    if got is None:
        assert dryrun.SKIPS[(name, shape)] == jdry.SKIPS[(name, shape)]
        return
    assert (got.seq_len, got.global_batch, got.kind, got.variant) == (
        want.seq_len, want.global_batch, want.kind, want.variant)
    for f in ("layer_pattern", "window", "remat", "n_layers"):
        assert getattr(got.model, f) == getattr(want.model, f), f


def test_skips_and_swa_match_jax():
    jdry = _jax_dryrun()
    assert dryrun.SKIPS == jdry.SKIPS
    assert dryrun.SWA_FOR_LONG == jdry.SWA_FOR_LONG


def _names(shape):
    return ("pod", "data", "model")[-len(shape):]


def _spec_items(tree, prefix=""):
    """(path, ParamSpec) of a spec tree in flattening order (sorted keys),
    a ParamSpec taken whole."""
    if isinstance(tree, pspec.ParamSpec):
        return [(prefix, tree)]
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    return [x for k, v in items
            for x in _spec_items(v, f"{prefix}/{k}" if prefix else str(k))]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("mshape", [(1, 1), (16, 16), (2, 16, 16)])
def test_plan_for_zero_pod_matches_jax(mshape, kind):
    from repro.launch.steps import plan_for as jplan
    B_, S_ = {"train": (256, 4096), "prefill": (32, 8192),
              "decode": (128, 32768)}[kind]
    run = RunConfig(model=get_config("llama2-7b"), seq_len=S_,
                    global_batch=B_, kind=kind)
    jrun = JRun(model=jget("llama2-7b"), seq_len=S_, global_batch=B_,
                kind=kind)
    got = steps.plan_for(run, Mesh(mshape, _names(mshape)), zero_pod=True)
    want = jplan(jrun, types.SimpleNamespace(axis_names=_names(mshape),
                                             devices=np.empty(mshape)),
                 zero_pod=True)
    assert (got.zero_pod, got.batch_axes, got.scheme, got.kv_axes,
            got.microbatches) == (want.zero_pod, want.batch_axes,
                                  want.scheme, want.kv_axes,
                                  want.microbatches)
    assert dict(got.rules.table) == dict(want.rules.table)


@pytest.mark.parametrize("name", ["llama2-7b", "llama3-405b",
                                  "granite-moe-1b-a400m"])
def test_zero_pod_cuts_the_moments_embed_dim(name):
    """Every moment with an ``embed`` dim that "pod" divides is cut over
    it (the other leaves and the params are not); without "pod" nothing
    changes."""
    run = RunConfig(model=get_config(name), seq_len=4096, global_batch=256,
                    kind="train")
    model = build_model(run.model)
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"))
    st = steps.train_state_shardings(model, steps.plan_for(
        run, mesh, zero_pod=True))
    specs = _spec_items(model.param_spec())
    moms = steps.spec_leaves(st.opt.mu)
    pars = steps.spec_leaves(st.params)
    assert len(moms) == len(pars) == len(specs)
    for (path, ps), m, p in zip(specs, moms, pars):
        assert not steps._cuts(p, "pod"), path
        cut = "embed" in ps.axes and ps.shape[ps.axes.index("embed")] % 2 == 0
        assert steps._cuts(m, "pod") == cut, (path, m)
    plain = steps.train_state_shardings(model, steps.plan_for(run, mesh))
    assert steps.spec_leaves(plain.opt.mu) == pars


@pytest.fixture(scope="module")
def zero_pod(tmp_path_factory):
    from repro.training import TrainState as JTrainState
    from repro.training import make_train_step as jmake_train_step
    jm = jbuild(jget("llama2-7b").smoke())
    jp = jm.init_params(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    V = jget("llama2-7b").smoke().vocab_size
    batches = [{k: rng.integers(0, V, (B, 16)).astype(np.int32)
                for k in ("inputs", "targets")} for _ in range(2)]
    params = jax.tree_util.tree_map(np.asarray, jp)
    jstep = jax.jit(jmake_train_step(jm, lr=3e-4, impl="jnp"))
    st = JTrainState.create(jp)
    for b in batches:
        st, _ = jstep(st, {k: jnp.asarray(v) for k, v in b.items()})
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, st.params),
                             "cpu")
    got = run_ranks(tmp_path_factory.mktemp("zero_pod"), "zero_pod_case",
                    {"params": params, "batches": batches}, (2, 1))
    return got, {p: x.numpy() for p, x in tree_paths(want)}


def test_zero_pod_step_equals_plain_and_jax(zero_pod):
    got, want = zero_pod
    for r in got:
        for path, w in want.items():
            close(r["zero_pod"][path], r["plain"][path], ZERO_TOL)
            close(r["zero_pod"][path], w, STEP_TOL)
        # one all_gather per cut leaf and step, none in the plain plan
        n_cut = sum(a != b for a, b in zip(r["zero_pod/mu"].values(),
                                           r["plain/mu"].values()))
        assert r["zero_pod/gathers"] == 2 * n_cut > 0


def test_zero_pod_rank_holds_half_the_embed_moments(zero_pod):
    got, _ = zero_pod
    spec = dict(_spec_items(build_model(
        get_config("llama2-7b").smoke()).param_spec()))
    for r in got:
        for path, shape in r["zero_pod/mu"].items():
            whole = r["plain/mu"][path]
            ps = spec[path]
            if "embed" in ps.axes:
                d = ps.axes.index("embed")
                assert shape[d] * 2 == whole[d], path
                assert shape[:d] + shape[d + 1:] == whole[:d] + whole[d + 1:]
            else:
                assert shape == whole, path


# ---------------------------------------------------------------------------
# the kernels' stand-ins
# ---------------------------------------------------------------------------
def _fake(fn, *shapes_dtypes):
    """``fn`` on fake CPU tensors of ``shapes_dtypes`` in dry mode: its
    outputs' (shape, dtype) and the tally."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    tally = kernels.KernelTally()
    with FakeTensorMode(), kernels.dry_mode(tally):
        args = [torch.empty(s, dtype=d) for s, d in shapes_dtypes]
        out = fn(*args)
        outs = out if isinstance(out, tuple) else (out,)
        return [(tuple(o.shape), o.dtype) for o in outs], tally


def _shapes(out):
    outs = out if isinstance(out, tuple) else (out,)
    return [(tuple(o.shape), o.dtype) for o in outs]


def _decode_inputs(dtype):
    Bq, Hkv, G, D, P, mp = 2, 2, 3, 64, 16, 5
    return [((Bq, Hkv, G, D), dtype), ((Bq * mp, P, Hkv, D), dtype),
            ((Bq * mp, P, Hkv, D), dtype), ((Bq, mp), torch.int32),
            ((Bq,), torch.int32)]


def _real(specs):
    out = []
    for s, d in specs:
        if d == torch.int32:
            out.append(torch.zeros(s, dtype=d))
        else:
            out.append(torch.randn(s).to(d))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_stand_ins_match_the_plain_shapes(dtype):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    inputs = _decode_inputs(dtype)
    real = _real(inputs)
    real[3] = torch.arange(10, dtype=torch.int32).reshape(2, 5)
    real[4] = torch.tensor([70, 3], dtype=torch.int32)
    kw = dict(scale=0.125, pages_per_block=2, num_splits=2)
    for fn, keys in ((pa.paged_attention_partials, {"paged_decode": 1}),
                     (pa.paged_attention_kernel, {
                         "paged_decode": 1, "combine": 1,
                         "combine/decode": 1})):
        got, tally = _fake(lambda *a: fn(*a, **kw), *inputs)
        assert got == _shapes(fn(*real, **kw))
        assert dict(tally.launches) == keys
        assert set(keys) <= set(kernels.launch_counts())
        assert tally.flops > 0 and tally.bytes > 0


@pytest.mark.parametrize("route", ["decode", "dist"])
def test_combine_stand_in_matches_the_plain_shapes(route):
    from repro_torch.kernels.paged_attention import paged_attention as pa
    ms = ((2, 3, 4, 5), torch.float32)
    acc = ((2, 3, 4, 5, 64), torch.float32)
    for dtype in (torch.float32, torch.bfloat16):
        def fn(m, l, a):
            return pa.combine_partials_kernel(m, l, a, dtype=dtype,
                                              route=route)
        got, tally = _fake(fn, ms, ms, acc)
        assert got == _shapes(fn(*_real([ms, ms, acc])))
        assert dict(tally.launches) == {"combine": 1,
                                        f"combine/{route}": 1}
        assert f"combine/{route}" in kernels.launch_counts()


def test_combine_prefill_and_k3_stand_ins_match_the_plain_shapes():
    from repro_torch.kernels.paged_attention import paged_attention as pa
    Bq, C, Hkv, G, D, P, mp, qb = 2, 7, 2, 3, 64, 8, 4, 2
    q = ((Bq, C, Hkv * G, D), torch.float32)
    pool = ((Bq * mp, P, Hkv, D), torch.float32)
    vec = ((Bq,), torch.int32)
    inputs = [q, pool, pool, ((Bq, mp), torch.int32), vec, vec]
    real = _real(inputs)
    real[3] = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    real[4] = torch.tensor([20, 9], dtype=torch.int32)
    real[5] = torch.tensor([13, 2], dtype=torch.int32)
    kw = dict(scale=0.125, num_splits=2, q_block=qb)
    got, tally = _fake(lambda *a: pa.paged_prefill_partials(*a, **kw),
                       *inputs)
    parts = pa.paged_prefill_partials(*real, **kw)
    assert got == _shapes(parts)
    assert dict(tally.launches) == {"paged_prefill": 1,
                                    "paged_prefill/tf32x3": 1}
    specs = [(tuple(t.shape), t.dtype) for t in parts]
    got, tally = _fake(lambda m, l, a: pa.combine_prefill_partials(
        m, l, a, C, qb, dtype=torch.bfloat16), *specs)
    assert got == _shapes(pa.combine_prefill_partials(
        *parts, C, qb, dtype=torch.bfloat16))
    assert dict(tally.launches) == {"combine": 1, "combine/prefill": 1}
    assert {"paged_prefill/tf32x3", "combine/prefill"} <= set(
        kernels.launch_counts())


@pytest.mark.parametrize("dtype,route", [(torch.float32, "tf32x3"),
                                         (torch.bfloat16, "tc")])
def test_flex_stand_in_matches_the_plain_shapes(dtype, route):
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention.ops import flex_attention
    Bq, H, Hkv, Q, D = 2, 4, 2, 200, 64
    qs = ((Bq, H, Q, D), dtype)
    ks = ((Bq, Hkv, Q, D), dtype)

    def fn(q, k, v):
        return flex_attention(q, k, v, mask_mod=flex.causal_mask)

    got, tally = _fake(fn, qs, ks, ks)
    assert got == _shapes(fn(*_real([qs, ks, ks])))
    assert dict(tally.launches) == {
        "flex_prefill": 1, f"flex_prefill/{route}": 1,
        f"flex_prefill/{route}/causal": 1}
    assert f"flex_prefill/{route}" in kernels.launch_counts()
    # the causal pairs of the Q true rows (the tiles' padding is not work)
    pairs = Bq * sum(q + 1 for q in range(Q))
    assert tally.flops == 4 * D * H * pairs


def test_mask_pairs_bounds():
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention.flex_attention import (
        lower_mods, mask_pairs)
    assert mask_pairs(lower_mods(flex.causal_mask), 4, 4) == 10
    assert mask_pairs(lower_mods(flex.full_mask), 3, 5) == 15
    assert mask_pairs(lower_mods(flex.sliding_window_mask(2)), 4, 4) == 7
    pad = flex.and_masks(flex.causal_mask,
                         flex.padding_mask(torch.tensor([1, 2])))
    assert mask_pairs(lower_mods(pad), 4, 4) == 10  # padding: all live


def _refused(fn, specs):
    """The error ``fn`` raises on fake tensors of ``specs`` in dry mode."""
    with pytest.raises((EngineConfigError, UnsupportedFeature)) as err:
        _fake(fn, *specs)
    return err.value


_PARTS = [((2, 3, 4, 5), torch.float32)] * 2 + [((2, 3, 4, 5, 64),
                                                  torch.float32)]
_PREFILL_PARTS = [((2, 2, 4, 2, 6), torch.float32)] * 2 + [
    ((2, 2, 4, 2, 6, 64), torch.float32)]


@pytest.mark.parametrize("case", [
    "combine f16 out", "combine bf16 partials", "combine prefill f16 out",
    "decode f16 q", "decode int8 pools unscaled", "decode head_dim 96",
    "prefill f16 q", "flex f16", "flex k shape"])
def test_dry_mode_refuses_what_the_card_refuses(case):
    """In dry mode each wrapper runs its checks before it stands in: a
    pair the card refuses raises the card's error, which the dry run
    records as ``"unsupported"`` (``UnsupportedFeature``) or an error."""
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention.flex_attention import (
        flex_attention_kernel)
    from repro_torch.kernels.paged_attention import paged_attention as pa
    f16, i8 = torch.float16, torch.int8
    decode = functools.partial(pa.paged_attention_kernel, scale=0.125)
    prefill = functools.partial(pa.paged_prefill_partials, scale=0.125)
    cases = {
        "combine f16 out": (lambda m, l, a: pa.combine_partials_kernel(
            m, l, a, dtype=f16), _PARTS, UnsupportedFeature),
        "combine bf16 partials": (pa.combine_partials_kernel, [
            (s, torch.bfloat16) for s, _ in _PARTS], EngineConfigError),
        "combine prefill f16 out": (lambda m, l, a: pa.combine_prefill_partials(
            m, l, a, 7, 2, dtype=f16), _PREFILL_PARTS, UnsupportedFeature),
        "decode f16 q": (decode, _decode_inputs(f16), UnsupportedFeature),
        "decode int8 pools unscaled": (decode, [
            (s, i8 if i in (1, 2) else d)
            for i, (s, d) in enumerate(_decode_inputs(torch.float32))],
            EngineConfigError),
        "decode head_dim 96": (decode, [
            (s[:-1] + (96,) if i < 3 else s, d)
            for i, (s, d) in enumerate(_decode_inputs(torch.float32))],
            UnsupportedFeature),
        "prefill f16 q": (prefill, [
            ((2, 7, 6, 64), f16), ((8, 8, 2, 64), f16), ((8, 8, 2, 64), f16),
            ((2, 4), torch.int32), ((2,), torch.int32), ((2,), torch.int32)],
            UnsupportedFeature),
    }
    if case.startswith("flex"):
        dtype = f16 if case == "flex f16" else torch.float32
        kv = 128 if case == "flex f16" else 64

        def fn(q, k, v):
            bm = flex.BlockMask(torch.ones(2, dtype=torch.int32),
                                torch.zeros(2, 1, dtype=torch.int32),
                                torch.zeros(2, 1, dtype=torch.bool), 64, 64)
            return flex_attention_kernel(q, k, v, bm, scale=0.125)
        cases[case] = (fn, [((1, 2, 128, 64), dtype),
                            ((1, 2, kv, 64), dtype),
                            ((1, 2, 128, 64), dtype)],
                       UnsupportedFeature if case == "flex f16"
                       else EngineConfigError)
    fn, specs, want = cases[case]
    assert type(_refused(fn, specs)) is want


def test_dry_run_records_a_kernel_refusal_as_unsupported():
    """A head dim that K1 does not take: the dry decode is refused where
    the card would refuse it."""
    res = dryrun.run_pair("llama2-7b", "decode_32k", False,
                          overrides={"n_layers": 1, "head_dim": 96})
    assert res["status"] == "unsupported", res
    assert "head_dim 96" in res["reason"]


def test_use_kernel_outside_dry_mode_is_unchanged():
    with pytest.raises(EngineConfigError, match="unsupported device"):
        kernels.use_kernel("k", torch.empty(2, device="meta"))
    assert kernels.use_kernel("k", torch.zeros(2)) is False
    # in dry mode a real CPU tensor still takes the plain version
    with kernels.dry_mode(kernels.KernelTally()):
        assert kernels.use_kernel("k", torch.zeros(2)) is False
        assert kernels.dry_tally(torch.zeros(2)) is None
        with pytest.raises(EngineConfigError, match="unsupported device"):
            kernels.use_kernel("k", torch.empty(2, device="meta"))
    assert kernels.dry_tally() is None


# ---------------------------------------------------------------------------
# meshes, the CLI
# ---------------------------------------------------------------------------
def test_dry_production_meshes():
    pod = tmesh.make_production_mesh(dry=True, rank=37)
    assert pod.shape == (16, 16) and pod.coords == (2, 5)
    g = pod.group(("model",))
    assert g.size == 16 and g.ranks == tuple(range(32, 48))
    assert pod.group(("data",)).ranks == tuple(range(5, 256, 16))
    multi = tmesh.make_production_mesh(multi_pod=True, dry=True, rank=300)
    assert multi.shape == (2, 16, 16)
    assert multi.group(("pod",)).ranks == (44, 300)
    assert multi.group(("pod", "data", "model")).size == 512
    assert tmesh.HBM_BYTES == 80e9 and tmesh.NODE_GPUS == 8
    assert tmesh.NET_BW == 50e9


def test_roofline_terms_split_the_links():
    t = ca.roofline_terms(989e12, 3.35e12, {"within_node": 450e9,
                                            "beyond_node": 50e9})
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(2.0)
    assert t["bottleneck"] == "collective_s"


def _cli(tmp_path, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv,
         "--outdir", str(tmp_path)], env=env, capture_output=True,
        text=True, timeout=600)


def test_cli_writes_a_pair_and_records_refusals(tmp_path):
    out = _cli(tmp_path, "--arch", "llama2-7b,xlstm-350m,whisper-medium",
               "--shape", "decode_32k,long_500k", "--mesh", "pod",
               "--override", "n_layers=2")
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads((tmp_path / "llama2-7b__decode_32k__pod.json"
                      ).read_text())
    assert res["status"] == "ok" and res["fits"] is True
    for key in ("memory", "cost_full", "collectives_full", "roofline",
                "kernels", "plan", "trace_s"):
        assert key in res, key
    # the card's decode path: K1 + K2 from one call, per layer
    assert res["kernels"] == {"combine": 2, "combine/decode": 2,
                              "paged_decode": 2}
    assert res["plan"]["scheme"] == "tp"
    assert 0 < res["roofline"]["useful_frac"] <= 1
    refused = json.loads((tmp_path / "xlstm-350m__decode_32k__pod.json"
                          ).read_text())
    assert refused["status"] == "unsupported" and refused["reason"]
    skipped = json.loads((tmp_path / "whisper-medium__long_500k__pod.json"
                          ).read_text())
    assert skipped["status"] == "skipped"


def test_run_pair_takes_the_rank():
    res = dryrun.run_pair("llama2-7b", "decode_32k", False, rank=17,
                          overrides={"n_layers": 1})
    assert res["status"] == "ok" and res["rank"] == 17
    # rank 17's tp decode: its 2 kv heads of 32, its 8 rows of 128
    assert res["collective_calls"] == {"all_reduce": 3, "all_gather": 1}


@pytest.mark.parametrize("name,shape", [("whisper-medium", "train_4k"),
                                        ("xlstm-350m", "train_4k"),
                                        ("llama-3.2-vision-11b",
                                         "decode_32k"),
                                        ("whisper-medium", "prefill_32k")])
def test_refused_pairs_are_unsupported(name, shape):
    """A family or pattern the distributed steps do not take is refused
    with ``UnsupportedFeature`` (recorded), never another error."""
    res = dryrun.run_pair(name, shape, False, overrides={"n_layers": 1})
    assert res["status"] == "unsupported", res
    assert "'A', 'W' and 'R'" in res["reason"]


@pytest.mark.parametrize("shape,n_layers", [("decode_32k", 3),
                                            ("train_4k", 1)])
def test_r_layer_pairs_trace(shape, n_layers):
    """recurrentgemma-9b traces on the pod mesh with its ``R`` blocks'
    channels over "model" (the plan's ``state`` cut): the gates' f32
    partials are reduce-scattered in every step, counted in
    ``collective_calls`` and the bytes sent, and the rank fits.
    ``decode_32k`` at one ``RRW`` unit (dp: one reduce-scatter per ``R``
    layer; K1 + K2 for the ``W`` layer), ``train_4k`` at one layer (its
    16 microbatches)."""
    res = dryrun.run_pair("recurrentgemma-9b", shape, False,
                          overrides={"n_layers": n_layers})
    assert res["status"] == "ok" and res["fits"], res
    assert res["plan"]["state"]
    calls = res["collective_calls"]
    assert calls.get("reduce_scatter", 0) > 0, calls
    sent = res["collectives_by_axes"]["model"]["reduce-scatter"]["sent"]
    assert 0 < sent <= res["collectives_full"]["total"]
    if shape == "decode_32k":
        assert res["plan"]["scheme"] == "dp"
        assert calls["reduce_scatter"] == 2
        assert res["kernels"]["paged_decode"] == 1
