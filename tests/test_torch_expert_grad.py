"""The MoE experts over "model" under grad, on ``gloo`` ranks against the
JAX package: GSPMD's cut (each rank E/m experts over its own tokens, the
partial sums reduced) and expert parallelism (``ep.apply_moe_ep``, the
tokens exchanged by all-to-all), in every MoE plan.

One JAX subprocess with 8 fake CPU devices gives the layer references:
``jax.grad`` through ``ep.apply_moe_ep`` under ``jit`` on the (1, 2),
(2, 2) and (1, 4) ("data", "model") meshes, and through the
single-device ``moe.apply_moe``, of ``Σ out·w + 0.01·aux`` on the smoke
granite-moe layer (4 experts, top 2, d 256) at capacity 1.25 and
dropless (0.0).  The model references are the single-device JAX
functions in this process (``jax.value_and_grad`` of ``loss_fn``,
``prefill``, ``decode_step``; the JAX sharded model fails under JAX
0.9.0).  One group of 4 CPU processes runs every case of the port
(``_torch_dist.expert_cases``).

- Layer, EP: the output and the aux loss at ``ATTN_TOL``, the gradients
  of ``x``, ``router``, ``wg``, ``wu`` and ``wd`` (the router's and the
  experts' summed over "data") within ``GRAD_TOL`` · (1 + |g|) of
  ``jax.grad`` on the same mesh: at (1, 4) an expert gradient counted
  once per model rank would miss by a factor of 4.
- Layer, the cut: on (1, 2) and (1, 4) at 1.25 and on (2, 2) dropless
  (each rank's capacity is its rows'), against the single-device JAX
  gradients.
- Model: ``train_grads`` and two ``build_train_step`` steps of the smoke
  granite-moe under both schedules on (1, 2) at 1.25 and on (2, 2)
  dropless against ``jax.value_and_grad`` of ``loss_fn`` (``GRAD_TOL``,
  ``LOSS_TOL``) and one device's plain step (``STEP_TOL``), plus the cut
  with 2 microbatches and with ZeRO-1 on (2, 1, 2).  EP at data 2 and
  the microbatched step are compared at ``router_aux_coef=0``: their aux
  loss follows another law than the whole batch's (EP: each shard's,
  averaged, which the layer cases hold against JAX's EP function;
  microbatches: each microbatch's), and their loss, ce and gradients
  then are the single-device ones.  Each rank holds E/m of every expert
  leaf and of its moments.
- Serving: prefill and 4 decode steps under the cut on (1, 2), dropless,
  against the JAX prefill and decode (logits at ``LOGIT_TOL``, greedy
  tokens equal).
- The (1, 2) plan under ``moe_ep`` trains (it raised before): finite
  gradients, every expert's nonzero.
- Dry against real: the cut and EP train steps on (2, 2) and (1, 2),
  the cut's decode and EP's prefill on (1, 2): FLOPs, the collectives'
  calls and bytes (the all-to-alls of the backward included) equal, the
  dry peak within ``PEAK_TOL`` and never below; on dry (4, 8) and
  (2, 16) meshes EP's all-to-alls (4 a layer under grad) land within a
  node of 8 or beyond it as the "model" group does.
- The layouts at production size: every train, prefill and decode plan
  of granite-moe and olmoe whose "model" axis divides the experts cuts
  them, with or without ``moe_ep``, in the params' and the moments'
  specs (``zero_pod`` too).
"""

import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_helpers import ATTN_TOL, LOGIT_TOL, close

from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data import synthetic_batches
from repro.models.api import build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
LOSS_TOL = 1e-5  # relative: loss, ce, aux
STEP_TOL = 2e-4  # params after each step against one device's
NORM_TOL = 1e-5  # relative: the global norm against one device's
PEAK_TOL = 0.01  # the dry peak within 1 % of the real CPU step's
STEPS = 2
DECODE_STEPS = 4
B, S = 4, 16
MOE = "granite-moe-1b-a400m"

EP_MESHES = [(1, 2), (2, 2), (1, 4)]
CAPS = [1.25, 0.0]
# name: (mesh, capacity, ep); the cut's reference is one device's
LAYER = {**{f"ep {shape} {cap}": (shape, cap, True)
            for shape in EP_MESHES for cap in CAPS},
         "cut (1, 2) 1.25": ((1, 2), 1.25, False),
         "cut (1, 4) 1.25": ((1, 4), 1.25, False),
         "cut (2, 2) 0.0": ((2, 2), 0.0, False)}
# name: (mesh, replace, microbatches, zero_pod, schedule, aux held to
#        the whole batch's)
TRAIN = {
    "cut": ((1, 2), {}, None, False, "cut", True),
    "ep": ((1, 2), {"moe_ep": True}, None, False, "ep", True),
    "cut_data": ((2, 2), {"moe_capacity": 0.0}, None, False, "cut", True),
    "ep_data": ((2, 2), {"moe_ep": True, "moe_capacity": 0.0,
                         "router_aux_coef": 0.0}, None, False, "ep",
                False),
    "cut_microbatched": ((2, 2), {"moe_capacity": 0.0,
                                  "router_aux_coef": 0.0}, 2, False, "cut",
                         False),
    "cut_zero_pod": ((2, 1, 2), {"moe_capacity": 0.0}, None, True, "cut",
                     True),
}
# name: (mesh, replace, lens)
PREFILL = {"cut": ((1, 2), {"moe_capacity": 0.0}, [37, 1, 53, 20])}
DRY = {"cut train (2, 2)": ((2, 2), "train", None, MOE),
       "ep train (2, 2)": ((2, 2), "train", None, MOE, {"moe_ep": True}),
       "cut train (1, 2)": ((1, 2), "train", None, MOE),
       "ep train (1, 2)": ((1, 2), "train", None, MOE, {"moe_ep": True}),
       "cut decode (1, 2)": ((1, 2), "decode", None, MOE),
       "ep prefill (1, 2)": ((1, 2), "prefill", None, MOE,
                             {"moe_ep": True})}


def _layer_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 8, 256)).astype(np.float32)
    w = rng.standard_normal((4, 8, 256)).astype(np.float32)
    return x, w


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_config
from repro.distributed import ep
from repro.distributed.sharding import use_mesh, DEFAULT_RULES
from repro.models import moe
from repro.models.api import build_model
x, w, meshes, caps = pickle.load(open({inp!r}, "rb"))
cfg0 = get_config("granite-moe-1b-a400m").smoke()
params = build_model(cfg0).init_params(jax.random.PRNGKey(0))
p = jax.tree_util.tree_map(lambda a: a[0], params["groups"]["0A"])["moe"]
out = {{"p": jax.tree_util.tree_map(np.asarray, p)}}
xj, wj = jnp.asarray(x), jnp.asarray(w)


def grads(fn, p, x):
    def loss(p, x):
        o, aux = fn(p, x)
        return jnp.sum(o * wj) + 0.01 * aux, (o, aux)
    (_, (o, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, x)
    res = {{k: np.asarray(v) for k, v in gp.items()}}
    res.update(x=np.asarray(gx), out=np.asarray(o), aux=float(aux))
    return res


for cap in caps:
    cfg = cfg0.replace(moe_capacity=cap, moe_ep=True)
    out["single/%s" % cap] = grads(lambda p, x: moe.apply_moe(p, x, cfg),
                                   p, xj)
    for shape in meshes:
        devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
        m = Mesh(devs, ("data", "model"))
        r = DEFAULT_RULES.extend(batch=("data",) if shape[0] > 1 else None)
        with use_mesh(m, r):
            out["ep/%s/%s" % (shape, cap)] = grads(
                lambda p, x: ep.apply_moe_ep(p, x, cfg), p, xj)
pickle.dump(out, open({outp!r}, "wb"))
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _layer_refs(tmp):
    x, w = _layer_inputs()
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump((x, w, EP_MESHES, CAPS), f)
    code = _JAX.format(src=os.path.abspath(SRC), inp=inp, outp=outp)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(outp, "rb") as f:
        return pickle.load(f)


def _train_ref(name, seed):
    mesh, repl, mb, zp, _, _ = TRAIN[name]
    cfg = get_config(MOE).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    batch = next(synthetic_batches(B, S, cfg.vocab_size, seed=seed,
                                   cfg=cfg))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jb), has_aux=True))(params)
    case = dict(mesh=mesh, config=MOE, replace=repl, batch=batch,
                microbatches=mb, zero_pod=zp, attn=None, params=_np(params),
                grads=_np(grads), steps=STEPS)
    return case, dict(loss=float(loss), ce=float(parts["ce"]),
                      aux=float(parts["aux"]))


def _prefill_ref(name, seed):
    mesh, repl, lens = PREFILL[name]
    cfg = get_config(MOE).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (len(lens), max(lens))).astype(
        np.int32)
    lens = np.asarray(lens, np.int32)
    run = RunConfig(model=cfg, seq_len=max(lens) + DECODE_STEPS,
                    global_batch=len(lens), kind="decode")
    state = model.init_decode_state(run)
    pps = state["tables"].shape[2]
    state["tables"] = jnp.arange(len(lens) * pps, dtype=jnp.int32).reshape(
        len(lens), 1, pps)
    prefill = jax.jit(model.prefill, static_argnames=("impl",))
    decode = jax.jit(model.decode_step, static_argnames=("impl",))
    logits, state = prefill(params, jnp.asarray(tokens), state,
                            lens=jnp.asarray(lens), impl="jnp")
    ref = {"prefill": np.asarray(logits)}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps, forced = [], []
    for _ in range(DECODE_STEPS):
        forced.append(np.asarray(tok))
        logits, state = decode(params, tok, state, impl="ref")
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    ref["steps"] = np.stack(steps)
    ref["greedy"] = np.stack(forced[1:] + [np.asarray(tok)])
    case = dict(mesh=mesh, config=MOE, replace=repl, tokens=tokens,
                lens=lens, steps=DECODE_STEPS, scheme=None,
                forced=np.stack(forced), params=_np(params))
    return case, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    layer_refs = _layer_refs(tmp_path_factory.mktemp("expert_jax"))
    x, w = _layer_inputs()
    layer = {name: dict(mesh=shape, capacity=cap, ep=ep, p=layer_refs["p"],
                        x=x, w=w)
             for name, (shape, cap, ep) in LAYER.items()}
    train, prefill, refs = {}, {}, {}
    for i, name in enumerate(TRAIN):
        train[name], refs[f"train/{name}"] = _train_ref(name, 80 + i)
    for i, name in enumerate(PREFILL):
        prefill[name], refs[f"prefill/{name}"] = _prefill_ref(name, 90 + i)
    got = run_ranks(tmp_path_factory.mktemp("expert"), "expert_cases",
                    {"layer": layer, "train": train, "prefill": prefill,
                     "dry": {"cases": DRY, "B": B, "S": 32}}, (2, 2),
                    timeout=600)
    return layer_refs, refs, got


@pytest.mark.parametrize("name", list(LAYER))
def test_moe_layer_grads_match_jax(ranks, name):
    """Each rank's rows of the output and of x's gradient, the aux loss,
    and the router's and its experts' gradients (summed over "data")
    against ``jax.grad`` through the JAX EP function on the same mesh
    (EP), or through the single-device JAX function (the cut)."""
    layer_refs, _, got = ranks
    shape, cap, ep = LAYER[name]
    want = layer_refs[f"ep/{shape}/{cap}" if ep else f"single/{cap}"]
    for r in got:
        c = r[f"layer/{name}"]
        rows, ex = slice(*c["rows"]), slice(*c["experts"])
        close(c["out"], want["out"][rows], ATTN_TOL)
        assert abs(c["aux"] - want["aux"]) <= ATTN_TOL * (1 + abs(
            want["aux"]))
        close(c["x"], want["x"][rows], GRAD_TOL)
        close(c["router"], want["router"], GRAD_TOL)
        for k in ("wg", "wu", "wd"):
            close(c[k], want[k][ex], GRAD_TOL)


def test_jax_ep_law_differs_from_the_whole_batch(ranks):
    """Why the EP cases at data 2 are held to JAX's EP function: its aux
    loss (each shard's, averaged) is not the single device's."""
    layer_refs, _, _ = ranks
    ep, one = layer_refs["ep/(2, 2)/0.0"], layer_refs["single/0.0"]
    assert abs(ep["aux"] - one["aux"]) > 10 * ATTN_TOL * (1 + abs(one["aux"]))
    close(ep["out"], one["out"], ATTN_TOL)  # dropless: the same outputs


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_grads_match_jax(ranks, name):
    _, refs, got = ranks
    ref = refs[f"train/{name}"]
    whole_aux = TRAIN[name][-1]
    for r in got:
        c = r[f"train/{name}"]
        assert c["grad_err"] <= GRAD_TOL, (name, c["grad_err"])
        for k in ("loss", "ce") + (("aux",) if whole_aux else ()):
            assert abs(c[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, c[k])


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_device(ranks, name):
    _, _, got = ranks
    for r in got:
        c = r[f"train/{name}"]
        assert max(c["param_err"]) <= STEP_TOL, c["param_err"]
        close(c["gnorm"], c["one_gnorm"], NORM_TOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_holds_its_experts_and_their_moments(ranks, name):
    """E/m of every expert leaf, and of its AdamW moments, on each rank,
    under the schedule the config asks for."""
    mesh, _, mb, _, sched, _ = TRAIN[name]
    _, _, got = ranks
    for r in got:
        c = r[f"train/{name}"]
        assert c["moe"] == sched
        held, whole = c["experts"]
        assert set(held) == set(c["expert_moments"]) == {whole // mesh[-1]}
        assert c["microbatches"] == (mb or 1)
        if sched == "ep":
            assert c["calls"].get("all_to_all", 0) > 0
        else:
            assert c["calls"].get("all_to_all", 0) == 0


def test_train_under_expert_parallelism_trains(ranks):
    """The plan ``moe_ep`` on (1, 2) (which the port refused to train
    before): finite gradients, every expert leaf's nonzero."""
    _, _, got = ranks
    for r in got:
        c = r["ep_trains"]
        assert c["moe"] == "ep"
        assert c["finite"] and c["nonzero"]
        assert np.isfinite(c["loss"]) and np.isfinite(c["aux"])


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_and_decode_under_the_cut_match_jax(ranks, name):
    _, refs, got = ranks
    ref = refs[f"prefill/{name}"]
    for r in got:
        c = r[f"prefill/{name}"]
        lo = c["row0"] * c["rows"]
        rows = slice(lo, lo + c["rows"])
        close(c["prefill"], ref["prefill"][rows], LOGIT_TOL)
        close(c["steps"], ref["steps"][:, rows], LOGIT_TOL)
        np.testing.assert_array_equal(c["steps"].argmax(-1),
                                      ref["greedy"][:, rows])


@pytest.mark.parametrize("name", list(DRY))
def test_dry_step_matches_the_real_step(ranks, name):
    """The dry trace of both schedules, under grad in training: FLOPs and
    the collectives (the backward's all-to-alls and all-reduces
    included) equal, the peak within ``PEAK_TOL`` and never below."""
    _, _, got = ranks
    ep = len(DRY[name]) > 4
    for r in got:
        c = r["dry"][name]
        real, dry = c["real"], c["dry"]
        assert dry["flops"] == real["flops"]
        assert dry["calls"] == real["calls"]
        assert dry["coll_bytes"] == real["coll_bytes"]
        assert (real["calls"].get("all_to_all", 0) > 0) == ep
        rp, dp = real["memory"]["peak_bytes"], dry["memory"]["peak_bytes"]
        assert rp <= dp <= rp * (1 + PEAK_TOL), (rp, dp)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("name", [MOE, "olmoe-1b-7b"])
def test_every_moe_plan_cuts_the_experts(name, kind):
    """GSPMD's rule (``experts: ("model",)``): wherever "model" divides
    the experts, the plan's layout cuts them, with or without
    ``moe_ep`` (which picks the schedule only), in the params' specs and
    the moments'; with ``zero_pod`` too.  A "model" axis that does not
    divide them leaves them whole."""
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.distributed.sharding import P
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.api import build_model as tbuild
    shapes = {"train": (256, 4096), "prefill": (32, 8192),
              "decode": (128, 32768)}[kind]
    for ep in (False, True):
        cfg = tget(name).replace(moe_ep=ep)
        run = TRun(model=cfg, seq_len=shapes[1], global_batch=shapes[0],
                   kind=kind)
        model = tbuild(cfg)
        for mshape, names in (((1, 2), ("data", "model")),
                              ((2, 4), ("data", "model")),
                              ((16, 16), ("data", "model")),
                              ((2, 16, 16), ("pod", "data", "model")),
                              ((1, 3), ("data", "model"))):
            cut = cfg.n_experts % mshape[-1] == 0
            for zp in ((False, True) if kind == "train" else (False,)):
                plan = steps.plan_for(run, Mesh(mshape, names), zero_pod=zp)
                lay = plan.layout
                assert (lay.experts, lay.ep) == (cut, cut and ep)
                assert lay.moe() == ("whole" if not cut else
                                     "ep" if ep else "cut")
                want = P("model") if cut else P()
                trees = [steps.param_specs(model, plan)]
                if kind == "train":
                    st = steps.train_state_shardings(model, plan)
                    trees += [st.params, st.opt.mu, st.opt.nu]
                for tree in trees:
                    for lp in tree["layers"]:
                        for k in ("wg", "wu", "wd"):
                            assert lp["moe"][k][:1] == tuple(want)[:1], (
                                mshape, k, lp["moe"][k])
                        assert not steps._cuts(lp["moe"]["router"],
                                               "model")


@pytest.mark.parametrize("mshape", [(4, 8), (2, 16)])
def test_dry_all_to_all_bytes_land_where_the_mesh_puts_them(mshape):
    """The dry EP train step of rank 0 (the smoke granite-moe with 16
    experts) on a dry (data, model) mesh: forward and backward exchange
    over the "model" group, 4 all-to-alls a layer, all within a node of
    8 when "model" is 8 ranks, all beyond it when it is 16."""
    import torch
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.launch import cost_analysis as ca
    from repro_torch.launch.mesh import NODE_GPUS, make_dry_mesh
    from repro_torch.launch.steps import dry_step, plan_for
    cfg = tget(MOE).smoke().replace(n_experts=16, moe_ep=True)
    run = TRun(model=cfg, seq_len=16, global_batch=mshape[0], kind="train")
    plan = plan_for(run, make_dry_mesh(mshape, ("data", "model"), 0),
                    attn_impl="ref")
    assert plan.layout.moe() == "ep"
    rec = dry_step(run, plan, torch.float32)
    a2a = [op for op in rec.stats["ops"] if op[0] == "all_to_all"]
    assert len(a2a) == rec.stats["calls"]["all_to_all"] == 4 * cfg.n_layers
    m = mshape[1]
    assert all(op[2] == m and op[3] == tuple(range(m)) for op in a2a)
    where = ca.collective_bytes({"ops": a2a})
    assert where["all-to-all"] == sum(b * (m - 1) / m for _, b, _, _ in a2a)
    moved = "beyond_node" if m > NODE_GPUS else "within_node"
    assert where[moved] == where["total"] > 0
