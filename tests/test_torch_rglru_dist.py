"""RecurrentGemma's ``R`` layers under a mesh: the RG-LRU blocks cut over
"model" by the JAX ``state`` rule (``TPLayout.state``) in every train,
prefill and decode plan, their recurrent state carried across ranks, on
``gloo`` ranks against the single-device JAX model.

The JAX sharded step fails under JAX 0.9.0 (``sharding.logical_shard``),
so the references are the single-device JAX functions of the smoke
recurrentgemma (``RW``: d 256, ``lru_width`` 256, 4 heads over 1 kv head,
window 64; and ``RRW`` at 3 layers, whose two ``R`` layers stack their
state), the same params carried across through numpy.  One group of 4
CPU processes runs every case (``_torch_dist.rglru_dist_cases``).

- (a) Train: ``train_grads`` under the sequence-cut plan (the default)
  on (1, 2), (1, 4) and (2, 2), under the uncut plan (``seq_parallel=
  False``) and under the ring plan, against ``jax.value_and_grad`` of
  the JAX ``loss_fn`` (``GRAD_TOL``, ``LOSS_TOL``, as
  tests/test_torch_seq_parallel.py holds them), then two
  ``build_train_step`` steps against one device's plain step
  (``STEP_TOL``).  Every plan cuts the channels (``layout.state``) and
  each rank holds ``w/m`` of them.
- (b) Serving: a prefill under the prefill plan (cut along the sequence,
  uncut, ring), ``shard_decode_state`` into the dp decode plan (the
  recurrent state of the rank's rows and channels) and 6 decode steps:
  logits at ``LOGIT_TOL`` and greedy tokens equal to JAX's on rows of
  the full length (JAX takes every row's state at the padded end, its
  fault 3); a padded wave against the port's single-device path.  The
  ``wa|wi`` reduce-scatter is one call a layer and step (the decode
  steps' collective counts and bytes), and the state holds the rank's
  channels before and after ``shard_decode_state``.
- (c) Weight-stationary decode (``ws_decode``) on (2, 1) and (2, 2): the
  prefill's rows gathered by ``shard_decode_state`` (``rec`` in the
  order of ``shard_batch``), 6 steps against JAX's.
- (d) The dry step against the real one (FLOPs, collectives' calls and
  bytes equal, the peak within ``PEAK_TOL``) for the train, prefill,
  decode and ws decode steps; the train CLI on (1, 2) against the same
  run on one rank.
- In-process: ``init_params`` under a plan is the cut of the whole draw;
  ``shard_decode_state`` cuts a whole state's channels and refuses other
  state; the spec trees against JAX's (the ``rec`` channels over "model"
  the one named departure); ``C``, ``M``, ``S`` and the encoder–decoder's
  train step still refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_helpers import LOGIT_TOL, close
from test_torch_launch import (_expected_specs, _jax_mesh,  # noqa: F401
                               _leaves_by_path, _names, _norm, _runs,
                               jax_specs)

from repro.configs import get_config as jget
from repro.configs.base import RunConfig as JRun
from repro.data import synthetic_batches
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_config
from repro_torch.configs.base import RunConfig
from repro_torch.distributed.collectives import shard_decode_state
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.launch import steps
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params_from_numpy
from repro_torch.models.api import build_model

GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
LOSS_TOL = 1e-5  # relative: loss, ce
STEP_TOL = 2e-4  # params after each step against one device's
PEAK_TOL = 0.01  # the dry peak within 1 % of the real CPU step's
STEPS = 2
DECODE_STEPS = 6
B, S = 4, 16
RG = "recurrentgemma-9b"
RRW = {"n_layers": 3, "layer_pattern": "RRW"}
# prompts of 72 tokens: past the window of 64 (the W layer's ring wraps),
# 36 / 18 a rank under the sequence cut
SP = 72
PADDED = [72, 9, 40, 61]

# name: (mesh, replace, plan knobs, against)
TRAIN = {
    "seq (1, 2)": ((1, 2), {}, {}, {"seq_parallel": False}),
    "seq (1, 4)": ((1, 4), {}, {}, None),
    "seq (2, 2)": ((2, 2), {}, {}, {"seq_parallel": False}),
    "seq (1, 2) RRW": ((1, 2), RRW, {}, None),
    "no-seq (1, 2)": ((1, 2), {}, {"seq_parallel": False}, None),
    "ring (1, 2)": ((1, 2), {}, {"ring": True}, None),
    "ring (1, 4) RRW": ((1, 4), RRW, {"ring": True}, None),
}
# name: (mesh, replace, plan knobs, lens)
PREFILL = {
    "seq (1, 2)": ((1, 2), {}, {}, None),
    "seq (1, 4)": ((1, 4), {}, {}, None),
    "seq (2, 2) RRW": ((2, 2), RRW, {}, None),
    "no-seq (1, 2)": ((1, 2), {}, {"seq_parallel": False}, None),
    "ring (1, 2) RRW": ((1, 2), RRW, {"ring": True}, None),
    "padded seq (1, 2) RRW": ((1, 2), RRW, {}, PADDED),
}
# name: (mesh, replace)
WS = {"(2, 1)": ((2, 1), {}), "(2, 2) RRW": ((2, 2), RRW)}
DRY = {"train (1, 2)": ((1, 2), "train", None, RG),
       "ring train (1, 2)": ((1, 2), "train", None, RG, {}, {"ring": True}),
       "prefill (1, 2)": ((1, 2), "prefill", None, RG, RRW),
       "decode (1, 2)": ((1, 2), "decode", None, RG, RRW),
       "decode (2, 2)": ((2, 2), "decode", None, RG),
       "ws decode (2, 1)": ((2, 1), "decode", None, RG, {},
                            {"ws_decode": True})}
CLI = {"mesh": (1, 2), "config": RG, "steps": 2, "batch": 4, "seq": 16}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfgs(repl):
    return (jget(RG).smoke().replace(**repl),
            get_config(RG).smoke().replace(**repl))


def _train_ref(repl, seed):
    cfg, _ = _cfgs(repl)
    model = jbuild(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    batch = next(synthetic_batches(B, S, cfg.vocab_size, seed=seed, cfg=cfg))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jb), has_aux=True))(params)
    return (dict(batch=batch, params=_np(params), grads=_np(grads)),
            dict(loss=float(loss), ce=float(parts["ce"])))


def _serve_ref(repl, seed, lens=None):
    """The JAX prefill of 4 prompts of ``SP`` tokens and ``DECODE_STEPS``
    greedy decode steps (rows of the full length; with ``lens`` the
    port's own single-device path instead, JAX's padded rows being its
    fault 3)."""
    cfg, tcfg = _cfgs(repl)
    model = jbuild(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (4, SP)).astype(np.int32)
    lens = np.asarray(lens or [SP] * 4, np.int32)
    run = JRun(model=cfg, seq_len=SP + DECODE_STEPS, global_batch=4,
               kind="decode")
    case = dict(config=RG, replace=repl, tokens=tokens, lens=lens,
                steps=DECODE_STEPS, params=_np(params))
    if (lens == SP).all():
        state = model.init_decode_state(run)
        pps = state["tables"].shape[2]
        state["tables"] = jnp.arange(4 * pps, dtype=jnp.int32).reshape(
            4, 1, pps)
        prefill = jax.jit(model.prefill, static_argnames=("impl",))
        decode = jax.jit(model.decode_step, static_argnames=("impl",))
        logits, state = prefill(params, jnp.asarray(tokens), state,
                                lens=jnp.asarray(lens), impl="jnp")
        step = lambda tok, st: decode(params, tok, st, impl="ref")  # noqa
        argmax = lambda x: jnp.argmax(x, -1).astype(jnp.int32)  # noqa
    else:  # the port on one device, the same weights
        tm = build_model(tcfg)
        tp = params_from_numpy(case["params"], "cpu")
        trun = RunConfig(model=tcfg, seq_len=SP + DECODE_STEPS,
                         global_batch=4, kind="decode")
        state = tm.init_decode_state(trun, device="cpu")
        pps = state["tables"].shape[2]
        state["tables"] = torch.arange(4 * pps, dtype=torch.int32).reshape(
            4, 1, pps)
        with torch.no_grad():
            logits, state = tm.prefill(tp, torch.from_numpy(tokens), state,
                                       torch.from_numpy(lens), impl="ref")
        step = lambda tok, st: tm.decode_step(  # noqa: E731
            tp, torch.as_tensor(np.asarray(tok)), st, impl="ref")
        argmax = lambda x: x.argmax(-1).int()  # noqa: E731
    ref = {"prefill": np.asarray(logits)}
    tok = argmax(logits)
    out, forced = [], []
    with torch.no_grad():
        for _ in range(DECODE_STEPS):
            forced.append(np.asarray(tok))
            logits, state = step(tok, state)
            out.append(np.asarray(logits))
            tok = argmax(logits)
    ref["steps"] = np.stack(out)
    ref["greedy"] = np.stack(forced[1:] + [np.asarray(tok)])
    case["forced"] = np.stack(forced)
    return case, ref


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    refs = {}
    train = {}
    for i, (name, (mesh, repl, knobs, against)) in enumerate(TRAIN.items()):
        key = tuple(sorted(repl.items()))
        if key not in refs:
            refs[key] = _train_ref(repl, len(refs))
        case, _ = refs[key]
        train[name] = dict(case, mesh=mesh, config=RG, replace=repl,
                           microbatches=None, steps=STEPS, plan=knobs)
        if against:
            train[name]["against"] = against
    prefill, prefs = {}, {}
    for i, (name, (mesh, repl, knobs, lens)) in enumerate(PREFILL.items()):
        case, prefs[name] = _serve_ref(repl, 30 + i, lens)
        prefill[name] = dict(case, mesh=mesh, scheme=None, plan=knobs)
    ws, wrefs = {}, {}
    for i, (name, (mesh, repl)) in enumerate(WS.items()):
        case, wrefs[name] = _serve_ref(repl, 50 + i)
        ws[name] = dict(case, mesh=mesh, scheme=None)
    ranks = run_ranks(tmp_path_factory.mktemp("rglru_dist"),
                      "rglru_dist_cases",
                      {"train": train, "prefill": prefill, "ws": ws,
                       "dry": {"cases": DRY, "B": B, "S": S}, "cli": CLI},
                      (2, 2), timeout=600)
    return ({k: r for k, (_, r) in refs.items()}, prefs, wrefs, ranks)


# ---------------------------------------------------------------------------
# (a) train
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(TRAIN))
def test_train_grads_match_jax(ran, name):
    refs, _, _, ranks = ran
    mesh, repl, knobs, against = TRAIN[name]
    ref = refs[tuple(sorted(repl.items()))]
    for r in ranks:
        got = r[f"train/{name}"]
        assert got["grad_err"] <= GRAD_TOL, got["grad_err"]
        for k in ("loss", "ce"):
            assert abs(got[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, got)
        if against:  # the same gradients without the sequence cut
            assert not got["against_seq"]
            assert got["against_err"] <= GRAD_TOL
            assert got["against_diff"] <= GRAD_TOL


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_device(ran, name):
    for r in ran[3]:
        got = r[f"train/{name}"]
        assert max(got["param_err"]) <= STEP_TOL, got["param_err"]
        close(got["gnorm"], got["one_gnorm"], 1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_plan_cuts_the_channels(ran, name):
    """Every train plan cuts the ``R`` channels over "model" (each rank
    holds ``w/m`` of the block's weights), the sequence where the plan
    says, and reduce-scatters (the gates' sums at least) in every step."""
    mesh, repl, knobs, _ = TRAIN[name]
    m = mesh[1]
    for r in ran[3]:
        got = r[f"train/{name}"]
        assert got["seq"] == knobs.get("seq_parallel", True)
        assert got["ring"] == bool(knobs.get("ring"))
        assert got["calls"].get("reduce_scatter", 0) > 0
        n_r = _cfgs(repl)[1].pattern().count("R")
        assert got["rec_rows"] == [256 // m] * n_r
        # the rank's share of the weights: vocab, d_ff and the channels
        # over m, the W layer's wq/wo by G/m heads, its wk/wv whole
        assert got["param_frac"] < 1 / m + 0.1


# ---------------------------------------------------------------------------
# (b) prefill, then dp decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_then_decode_matches_jax(ran, name):
    _, prefs, _, ranks = ran
    ref = prefs[name]
    mesh, repl, knobs, lens = PREFILL[name]
    rows = B // mesh[0]
    for r in ranks:
        got = r[f"prefill/{name}"]
        lo = got["row0"] * rows
        want = slice(lo, lo + rows)
        assert got["scheme"] == "dp"
        close(got["prefill"], ref["prefill"][want], LOGIT_TOL)
        close(got["steps"], ref["steps"][:, want], LOGIT_TOL)
        np.testing.assert_array_equal(got["steps"].argmax(-1),
                                      ref["greedy"][:, want])


@pytest.mark.parametrize("name", list(PREFILL))
def test_state_holds_the_rank_s_rows_and_channels(ran, name):
    """The prefilled state and the decode state after
    ``shard_decode_state``: the rank's rows and its ``w/m`` channels."""
    mesh, repl, knobs, _ = PREFILL[name]
    cfg = _cfgs(repl)[1]
    n_r, w = cfg.pattern().count("R"), cfg.lru_width // mesh[1]
    want = {"h": (n_r, B // mesh[0], w),
            "conv": (n_r, B // mesh[0], cfg.conv1d_width - 1, w)}
    for r in ran[3]:
        got = r[f"prefill/{name}"]
        assert got["rec_prefill"] == want and got["rec_decode"] == want


@pytest.mark.parametrize("name", list(PREFILL))
def test_gates_reduce_scatter_is_one_call_a_layer(ran, name):
    """Each decode step reduce-scatters the gates' packed f32 partials
    once per ``R`` layer (2w · rows · 4 bytes) and nothing else; the
    all-reduces are each layer's ``wout``/``wo`` and MLP sums and the
    vocab-cut lookup's; the one all-gather, the logits' vocab."""
    mesh, repl, _, _ = PREFILL[name]
    cfg = _cfgs(repl)[1]
    n_r, L = cfg.pattern().count("R"), cfg.n_layers
    rows = B // mesh[0]
    for r in ran[3]:
        got = r[f"prefill/{name}"]
        calls, nbytes = got["decode_calls"], got["decode_bytes"]
        assert calls["reduce_scatter"] == DECODE_STEPS * n_r
        assert nbytes["reduce_scatter"] == (DECODE_STEPS * n_r * 2
                                            * cfg.lru_width * rows * 4)
        assert calls["all_reduce"] == DECODE_STEPS * (2 * L + 1)
        assert calls["all_gather"] == DECODE_STEPS
        assert set(calls) == {"reduce_scatter", "all_reduce", "all_gather"}


# ---------------------------------------------------------------------------
# (c) weight-stationary decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(WS))
def test_ws_decode_matches_jax(ran, name):
    _, _, wrefs, ranks = ran
    ref = wrefs[name]
    mesh, _ = WS[name]
    for r in ranks:
        got = r[f"ws/{name}"]
        assert tuple(got["act_embed"]) == ("data",)
        assert got["prefill_rows"] == B // mesh[0] and got["rows"] == B
        close(got["steps"], ref["steps"], LOGIT_TOL)
        np.testing.assert_array_equal(got["steps"].argmax(-1),
                                      ref["greedy"])
        # the gates' reduce-scatter over "model" where it cuts the channels
        rs = [a for op, a in got["calls"] if op == "reduce_scatter"]
        n_r = _cfgs(WS[name][1])[1].pattern().count("R")
        assert rs == [("model",)] * (DECODE_STEPS * n_r if mesh[1] > 1
                                     else 0)


# ---------------------------------------------------------------------------
# (d) the dry step and the train CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(DRY))
def test_dry_step_matches_the_real_step(ran, name):
    for r in ran[3]:
        got = r["dry"][name]
        dry, real = got["dry"], got["real"]
        assert dry["flops"] == real["flops"] > 0
        assert dry["calls"] == real["calls"]
        assert dry["coll_bytes"] == real["coll_bytes"]
        if DRY[name][0][1] > 1:
            assert real["calls"]["reduce_scatter"] > 0
        assert real["memory"]["peak_bytes"] <= dry["memory"][
            "peak_bytes"] <= (1 + PEAK_TOL) * real["memory"]["peak_bytes"]


def test_train_cli_runs_r_layers_under_a_mesh(ran):
    for r in ran[3]:
        got = r["cli"]
        assert got["state"] and got["rec_wa"][0] == 256 // CLI["mesh"][1]
        close(got["losses"], got["one_losses"], LOSS_TOL)
        assert got["param_err"] <= STEP_TOL


# ---------------------------------------------------------------------------
# in-process: params, the state's boundary, spec trees, refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mshape", [(1, 2), (2, 2), (1, 4)])
def test_init_params_under_the_plan_is_the_cut_of_the_whole(mshape):
    cfg = _cfgs(RRW)[1]
    model = build_model(cfg)
    run = RunConfig(model=cfg, seq_len=32, global_batch=4, kind="train")
    whole = model.init_params(torch.Generator().manual_seed(3))
    for rank in range(int(np.prod(mshape))):
        plan = steps.plan_for(run, Mesh(mshape, rank=rank))
        assert plan.layout.state
        got = model.init_params(torch.Generator().manual_seed(3),
                                plan=plan)
        want = model.shard_params(whole, plan)
        g, w = _leaves(got), _leaves(want)
        assert g.keys() == w.keys()
        for k in g:
            assert torch.equal(g[k], w[k]), k
        m, r = mshape[1], plan.mesh.index("model")
        wl = cfg.lru_width // m
        rec = got["layers"][0]["rec"]
        full = whole["layers"][0]["rec"]
        assert torch.equal(rec["wa"], full["wa"][r * wl:(r + 1) * wl])
        assert torch.equal(rec["wx"], full["wx"][:, r * wl:(r + 1) * wl])
        assert torch.equal(rec["wout"], full["wout"][r * wl:(r + 1) * wl])


def _leaves(tree, prefix=""):
    """The leaves of a tree of dicts and lists by path."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _leaves(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_shard_decode_state_cuts_the_rec_channels():
    """A state of every channel is cut to the rank's ``w/m`` by the dp
    plan on (1, 2), each row kept; one of the rank's channels is kept as
    it is; other channel counts raise ``EngineConfigError``."""
    cfg = _cfgs(RRW)[1]
    model = build_model(cfg)
    run = RunConfig(model=cfg, seq_len=40, global_batch=3, kind="decode")
    st = model.init_decode_state(run, device="cpu")
    g = torch.Generator().manual_seed(5)
    for k, v in st["rec"]["R"].items():
        v.copy_(torch.randn(v.shape, generator=g))
    w = cfg.lru_width
    for rank in (0, 1):
        plan = steps.plan_for(run, Mesh((1, 2), rank=rank))
        assert plan.scheme == "dp" and plan.layout.state
        out = shard_decode_state(st, plan)
        for k, v in st["rec"]["R"].items():
            cut = out["rec"]["R"][k]
            assert torch.equal(cut, v[..., rank * w // 2:(rank + 1) * w // 2])
        again = shard_decode_state(out, plan)
        assert torch.equal(again["rec"]["R"]["h"], out["rec"]["R"]["h"])
        mine = model.init_decode_state(run, device="cpu", plan=plan)
        assert mine["rec"]["R"]["h"].shape == (2, 3, w // 2)
    bad = dict(st, rec={"R": {k: v[..., :w // 4] for k, v in
                              st["rec"]["R"].items()}})
    with pytest.raises(EngineConfigError, match="channels"):
        shard_decode_state(bad, plan)


@pytest.mark.parametrize("entry", ["M", "cross_k"])
def test_shard_decode_state_refuses_other_state(entry):
    cfg = _cfgs({})[1]
    model = build_model(cfg)
    run = RunConfig(model=cfg, seq_len=40, global_batch=2, kind="decode")
    st = model.init_decode_state(run, device="cpu")
    if entry == "M":
        st["rec"] = dict(st["rec"], M={"C": torch.zeros(1, 2, 4)})
    else:
        st["cross_k"] = torch.zeros(1, 2, 8, 1, 64)
    plan = steps.plan_for(run, Mesh((1, 2), rank=0))
    with pytest.raises(UnsupportedFeature):
        shard_decode_state(st, plan)


@pytest.mark.parametrize("mshape", [(1, 2), (2, 4), (16, 16), (2, 16, 16)])
def test_train_state_specs_match_jax(mshape, jax_specs):
    """The train plan's param specs of recurrentgemma-9b: JAX's
    ``make_param_shardings`` leaf for leaf, the ``rec`` weights cut by the
    ``state`` rule exactly as GSPMD cuts them."""
    run, jrun = _runs(RG, "train", 256, 4096)
    mesh = Mesh(mshape, _names(mshape))
    plan = steps.plan_for(run, mesh)
    jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape))
    model = build_model(run.model)
    assert plan.layout.state == (mshape[-1] > 1)
    got = steps.train_state_shardings(model, plan)
    sizes = dict(zip(_names(mshape), mshape))
    want = _expected_specs(model, plan, jplan.rules, _jax_mesh(mshape))
    g, w = _leaves_by_path(got.params), _leaves_by_path(want)
    assert sorted(g) == sorted(w)
    recs = [k for k in g if "/rec/" in k]
    assert len(recs) == 8 * run.model.pattern().count("R")
    for k in g:
        assert _norm(g[k], sizes) == _norm(w[k], sizes), k
    if mshape[-1] > 1:
        assert _norm(g["/layers/0/rec/wa"], sizes) == (("model",),)
        assert _norm(g["/layers/0/rec/wx"], sizes) == ((), ("model",))


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("mshape", [(1, 2), (16, 16), (2, 16, 16)])
def test_decode_state_specs_match_jax_but_the_rec_channels(mshape, kind,
                                                          jax_specs):
    """The state's shapes are JAX's; its specs JAX's for ``pos``, the
    tables and the decode pools (the prefill pools' head_dim cut is the
    departure tests/test_torch_launch.py names), and for ``rec`` JAX's
    rows with the channels over "model" besides (the port's layout: JAX
    keeps them whole over "model")."""
    sizes = dict(zip(_names(mshape), mshape))
    run, jrun = _runs(RG, kind, 32, 8192)
    plan = steps.plan_for(run, Mesh(mshape, _names(mshape)))
    jplan = jax_specs.plan_for(jrun, _jax_mesh(mshape))
    model, jm = build_model(run.model), jbuild(jrun.model)
    state = steps._abstract_state(model, run, plan, torch.bfloat16)
    jstate = jm.init_decode_state(jrun, jnp.bfloat16,
                                  n_kv_shards=jplan.n_kv_shards,
                                  abstract=True)
    assert {k: tuple(v.shape) for k, v in _leaves(state).items()} == {
        k: tuple(v.shape) for k, v in _leaves(jstate).items()}
    got = steps.decode_state_shardings(model, plan, state)
    want = jax_specs.decode_state_shardings(jm, jplan, jstate)
    for k in ("pos", "tables") + (("k_pages", "v_pages")
                                  if kind == "decode" else ()):
        assert _norm(got[k], sizes) == _norm(want[k], sizes), k
    for k, v in state["rec"]["R"].items():
        g = _pad(_norm(got["rec"]["R"][k], sizes), v.dim())
        w = _pad(_norm(want["rec"]["R"][k], sizes), v.dim())
        assert g[:-1] == w[:-1] and w[-1] == (), (k, g, w)
        assert g[-1] == (("model",) if sizes["model"] > 1 else ()), (k, g)


def _pad(spec, n):
    return spec + ((),) * (n - len(spec))


@pytest.mark.parametrize("name", ["llama-3.2-vision-11b", "xlstm-350m"])
def test_other_layers_stay_refused(name):
    """``C``, ``M`` and ``S`` layers: ``shard_params``, the decode state of a
    plan and the train step under a mesh raise ``UnsupportedFeature``."""
    cfg = get_config(name).smoke()
    model = build_model(cfg)
    run = RunConfig(model=cfg, seq_len=32, global_batch=2, kind="decode")
    plan = steps.plan_for(run, Mesh((1, 2), rank=0))
    with pytest.raises(UnsupportedFeature, match="'A', 'W' and 'R'"):
        model.init_decode_state(run, device="cpu", plan=plan)
    with pytest.raises(UnsupportedFeature, match="'A', 'W' and 'R'"):
        model.shard_params(model.init_params(
            torch.Generator().manual_seed(0)), plan)


def test_encdec_train_step_stays_refused():
    cfg = get_config("whisper-medium").smoke()
    model = build_model(cfg)
    with pytest.raises(UnsupportedFeature, match="'A', 'W' and 'R'"):
        model.loss_fn({}, {"inputs": None, "targets": None, "frames": None},
                      attn_ctx={"layout": None})
