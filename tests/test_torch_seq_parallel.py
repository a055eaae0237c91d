"""Sequence parallelism over "model" (JAX's default ``seq_parallel``)
and ring attention under grad and into the paged pools (``ring``), on
``gloo`` ranks against the JAX package.

One JAX subprocess with 8 fake CPU devices gives the ring references:
``jax.grad`` of ``Σ o·w`` through the JAX ``prefill_attention(impl=
"ring")`` under ``jit`` on the (1, 2), (1, 4) and (2, 2) ("data",
"model") meshes.  The model references are the single-device JAX
functions in this process (``jax.value_and_grad`` of ``loss_fn``,
``prefill``, ``decode_step``).  One group of 4 CPU processes runs every
case of the port (``_torch_dist.seq_parallel_cases``).

- (a) Ring under grad: the output at ``ATTN_TOL`` and the gradients of
  q, k and v (each rank's slice of its rows) within ``GRAD_TOL`` ·
  (1 + |g|), all finite: causal GQA, a window, a softcap, ``lens`` that
  pad out whole slices, and a window with ``lens`` that leave queries
  no live key at all.
- (b) Sequence-parallel ``train_grads`` on (1, 2), (1, 4) and (2, 2):
  smoke llama2-7b, its ``AW`` variant with a window, smoke granite-moe
  under GSPMD's expert cut and under ``moe_ep`` (dropless; EP at data 2
  at ``router_aux_coef=0``, its aux loss being each shard's), and
  ``remat`` with 2 microbatches, against ``jax.value_and_grad`` of the
  JAX ``loss_fn`` (``GRAD_TOL``, ``LOSS_TOL``); two ``build_train_step``
  steps against one device's plain step (``STEP_TOL``); the
  ``seq_parallel=False`` plan's gradients within ``GRAD_TOL`` too.
- (c) Ring ``train_grads``: the same models on (1, 2) and (1, 4) under
  ``ring=True``, held to the same references; smoke llama2-7b on (1, 2)
  also with every attention layer ``"whole"`` (the slice projected
  alone at its positions) and ``"q_heads"``.
- (d) Serving on (1, 2): a sequence-parallel prefill and a ring prefill
  under the tp, kvp and dp layouts, each then 4 decode steps under the
  decode plan of that scheme: logits at ``LOGIT_TOL``, greedy tokens
  equal to JAX's.  Row 1's single token leaves the second slice all
  padding.
- (f) Dry against real on (1, 2): the sequence-parallel and ring train
  and prefill steps — FLOPs, the collectives' calls and bytes equal,
  the dry peak within ``PEAK_TOL`` and never below; and a dry trace's
  residual stream between blocks is (B_l, S/m, d).
- Plans: ``test_plan_for_matches_jax`` and ``test_ring_prefill_param_
  specs_match_jax`` (tests/test_torch_launch.py) hold the rules of every
  knob and the ring prefill's param specs (attention whole over
  "model") to JAX's.
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
PEAK_TOL = 0.01  # the dry peak within 1 % of the real CPU step's
STEPS = 2
DECODE_STEPS = 4
B, S = 4, 16
LLAMA = "llama2-7b"
MOE = "granite-moe-1b-a400m"

# name: (B, S, H, Hkv, D, window, softcap, lens)
RING = {
    "gqa": (2, 32, 8, 2, 16, 0, 0.0, None),
    "window": (2, 32, 4, 4, 16, 6, 0.0, None),
    "softcap": (2, 32, 4, 2, 16, 0, 5.0, None),
    "padded": (2, 32, 8, 4, 16, 0, 0.0, [9, 20]),
    "padded_window": (2, 32, 4, 2, 16, 4, 0.0, [5, 28]),
}
RING_MESHES = [(1, 2), (1, 4), (2, 2)]

# model: (config, replace, microbatches, JAX reference)
MODELS = {
    "llama": (LLAMA, {}, None, "llama"),
    "window": (LLAMA, {"layer_pattern": "AW", "window": 5}, None, "window"),
    "moe_cut": (MOE, {"moe_capacity": 0.0}, None, "moe"),
    "moe_ep": (MOE, {"moe_capacity": 0.0, "moe_ep": True}, None, "moe"),
    "remat_mb": (LLAMA, {"remat": "full"}, 2, "llama"),
}
REFS = {"llama": (LLAMA, {}), "window": (LLAMA, {"layer_pattern": "AW",
                                                 "window": 5}),
        "moe": (MOE, {"moe_capacity": 0.0}),
        "moe_noaux": (MOE, {"moe_capacity": 0.0, "router_aux_coef": 0.0})}


def _train_cases():
    """name: (mesh, model, plan knobs); EP over two data ranks without
    the aux loss (its law is each shard's, ``tests/test_torch_expert_
    grad.py``)."""
    out = {}
    for mesh in ((1, 2), (1, 4), (2, 2)):
        for model in MODELS:
            out[f"seq {mesh} {model}"] = (mesh, model, {})
    for mesh in ((1, 2), (1, 4)):
        for model in MODELS:
            out[f"ring {mesh} {model}"] = (mesh, model, {"ring": True})
    for cut in RING_CUTS:
        out[f"ring (1, 2) llama {cut}"] = ((1, 2), "llama", {"ring": True})
    return out


# the ring train cases whose attention layers take a cut the plan would
# not pick for these heads: the whole weights (the slice projected alone)
# and the q heads over kv heads every rank holds
RING_CUTS = ("whole", "q_heads")
TRAIN = _train_cases()
# name: (decode scheme, plan knobs)
PREFILL = {f"{kind} {sch}": (sch, knobs)
           for kind, knobs in (("seq", {}), ("ring", {"ring": True}))
           for sch in ("tp", "kvp", "dp")}
PREFILL_LENS = [38, 1, 64, 20]  # S 64: row 1's slice 1 all padding
DRY = {"seq train (1, 2)": ((1, 2), "train", None, LLAMA),
       "ring train (1, 2)": ((1, 2), "train", None, LLAMA, {},
                             {"ring": True}),
       "seq prefill (1, 2)": ((1, 2), "prefill", None, LLAMA),
       "ring prefill (1, 2)": ((1, 2), "prefill", None, LLAMA, {},
                               {"ring": True})}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ring_inputs():
    rng = np.random.default_rng(0)
    out = {}
    for name, (b, s, h, hkv, d, window, cap, lens) in RING.items():
        out[name] = dict(
            q=rng.standard_normal((b, s, h, d)).astype(np.float32),
            k=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            v=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            w=rng.standard_normal((b, s, h, d)).astype(np.float32),
            window=window, softcap=cap,
            lens=None if lens is None else np.asarray(lens, np.int32))
    return out


_JAX = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import pickle
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.core.attention import prefill_attention
from repro.distributed.sharding import use_mesh, DEFAULT_RULES
cases, meshes = pickle.load(open({inp!r}, "rb"))
out = {{}}
for shape in meshes:
    devs = np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    rules = DEFAULT_RULES.extend(batch=("data",) if shape[0] > 1 else None,
                                 seq=("model",), heads=None, kv_heads=None)
    for name, c in cases.items():
        q, k, v, w = (jnp.asarray(c[n]) for n in ("q", "k", "v", "w"))
        l = None if c["lens"] is None else jnp.asarray(c["lens"])

        def f(q, k, v):
            o = prefill_attention(q, k, v, window=c["window"],
                                  softcap=c["softcap"], lens=l, impl="ring")
            return jnp.sum(o * w), o

        with use_mesh(mesh, rules):
            (_, o), g = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
        out["%s/%s" % (shape, name)] = (np.asarray(o),) + tuple(
            np.asarray(x) for x in g)
pickle.dump(out, open({outp!r}, "wb"))
"""


def _ring_refs(tmp, cases):
    inp, outp = str(tmp / "in.pkl"), str(tmp / "out.pkl")
    with open(inp, "wb") as f:
        pickle.dump((cases, RING_MESHES), f)
    code = _JAX.format(src=os.path.abspath(SRC), inp=inp, outp=outp)
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(outp, "rb") as f:
        return pickle.load(f)


def _train_ref(ref, seed):
    config, repl = REFS[ref]
    cfg = get_config(config).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    batch = next(synthetic_batches(B, S, cfg.vocab_size, seed=seed,
                                   cfg=cfg))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jb), has_aux=True))(params)
    return (dict(batch=batch, params=_np(params), grads=_np(grads)),
            dict(loss=float(loss), ce=float(parts["ce"]),
                 aux=float(parts["aux"])))


def _prefill_ref(seed):
    cfg = get_config(LLAMA).smoke()
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    lens = np.asarray(PREFILL_LENS, np.int32)
    Sp = 64
    tokens = rng.integers(0, cfg.vocab_size, (len(lens), Sp)).astype(
        np.int32)
    run = RunConfig(model=cfg, seq_len=Sp + DECODE_STEPS,
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
    ref["tokens"] = np.stack(forced[1:] + [np.asarray(tok)])
    case = dict(mesh=(1, 2), config=LLAMA, replace={}, tokens=tokens,
                lens=lens, steps=DECODE_STEPS, forced=np.stack(forced),
                params=_np(params))
    return case, ref


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    ring = _ring_inputs()
    jring = _ring_refs(tmp_path_factory.mktemp("seqpar_jax"), ring)
    ring_cases = {f"{shape} {name}": dict(c, mesh=shape)
                  for shape in RING_MESHES for name, c in ring.items()}
    refs = {ref: _train_ref(ref, i) for i, ref in enumerate(REFS)}
    train = {}
    for name, (mesh, model, knobs) in TRAIN.items():
        config, repl, mb, ref = MODELS[model]
        if model == "moe_ep" and mesh[0] > 1:
            repl, ref = dict(repl, router_aux_coef=0.0), "moe_noaux"
        case, _ = refs[ref]
        train[name] = dict(case, mesh=mesh, config=config, replace=repl,
                           microbatches=mb, steps=STEPS, plan=knobs,
                           ref=ref)
        if not knobs:
            train[name]["against"] = {"seq_parallel": False}
        cut = name.rsplit(" ", 1)[-1]
        if cut in RING_CUTS:
            train[name]["attn"] = cut
    pcase, pref = _prefill_ref(20)
    prefill = {name: dict(pcase, scheme=sch, plan=knobs)
               for name, (sch, knobs) in PREFILL.items()}
    ranks = run_ranks(tmp_path_factory.mktemp("seqpar"),
                      "seq_parallel_cases",
                      {"ring": ring_cases, "train": train,
                       "prefill": prefill,
                       "dry": {"cases": DRY, "B": B, "S": S}}, (2, 2),
                      timeout=600)
    return jring, {k: r for k, (_, r) in refs.items()}, train, pref, ranks


# ---------------------------------------------------------------------------
# (a) ring attention under grad
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", RING_MESHES)
@pytest.mark.parametrize("name", list(RING))
def test_ring_gradients_match_jax_grad_through_the_jax_ring(ran, shape,
                                                            name):
    jring, _, _, _, ranks = ran
    o, dq, dk, dv = jring[f"{shape}/{name}"]
    for r in ranks:
        got = r[f"ring/{shape} {name}"]
        b0, b1, s0, s1 = got["where"]
        close(got["o"], o[b0:b1, s0:s1], ATTN_TOL)
        for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
            g, w = got[key], want[b0:b1, s0:s1]
            assert np.isfinite(g).all(), key
            err = np.max(np.abs(g - w) / (1 + np.abs(w)))
            assert err <= GRAD_TOL, (key, err)


def test_ring_cases_mask_whole_chunks():
    """The padded cases hold the trap: on (1, 4) row 0's ``lens`` 9
    leaves slices 2 and 3 without a live key, and with a window of 4
    and ``lens`` 5 row 0's queries from position 8 on have none at
    all."""
    _, s, _, _, _, window, _, lens = RING["padded"]
    assert lens[0] <= s // 2
    _, s, _, _, _, window, _, lens = RING["padded_window"]
    assert lens[0] + window - 1 < s // 4 * 3


# ---------------------------------------------------------------------------
# (b), (c) the train plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(TRAIN))
def test_train_grads_match_jax(ran, name):
    _, refs, train, _, ranks = ran
    ref = refs[train[name]["ref"]]
    for r in ranks:
        got = r[f"train/{name}"]
        assert got["grad_err"] <= GRAD_TOL, (r, got["grad_err"])
        # EP over two data ranks: its aux loss is each shard's, averaged
        # (held to JAX's EP function in tests/test_torch_expert_grad.py)
        keys = ("loss", "ce") if train[name]["ref"] == "moe_noaux" else (
            "loss", "ce", "aux")
        for k in keys:
            assert abs(got[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, got)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_device(ran, name):
    _, _, _, _, ranks = ran
    for r in ranks:
        got = r[f"train/{name}"]
        assert max(got["param_err"]) <= STEP_TOL, got["param_err"]
        close(got["gnorm"], got["one_gnorm"], 1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_plan_cuts_the_sequence(ran, name):
    """Every case runs cut (``layout.seq``), the ring ones ring attention
    (the plan's ``attn_impl``), and the sequence-parallel ones also
    without the cut (``seq_parallel=False``) to the same gradients."""
    mesh, model, knobs = TRAIN[name]
    _, _, _, _, ranks = ran
    for r in ranks:
        got = r[f"train/{name}"]
        assert got["seq"] and got["ring"] == bool(knobs)
        assert got["attn_impl"] == ("ring" if knobs else "ref")
        assert got["microbatches"] == (MODELS[model][2] or 1)
        assert got["calls"].get("reduce_scatter", 0) > 0
        assert bool(got["calls"].get("send_recv")) == bool(knobs)
        cut = name.rsplit(" ", 1)[-1]
        if cut in RING_CUTS:
            assert set(got["attn"]) == {cut}
        if not knobs:
            assert not got["against_seq"]
            assert got["against_err"] <= GRAD_TOL
            assert got["against_diff"] <= GRAD_TOL


# ---------------------------------------------------------------------------
# (d) prefill, then decode
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_then_decode_matches_jax(ran, name):
    _, _, _, ref, ranks = ran
    for r in ranks:
        got = r[f"prefill/{name}"]
        assert got["seq"] and got["ring"] == name.startswith("ring")
        assert got["scheme"] == PREFILL[name][0]
        if got["ring"]:  # the weights whole, JAX's heads: None
            assert set(got["attn"]) == {"whole"}
        close(got["prefill"], ref["prefill"], LOGIT_TOL)
        close(got["steps"], ref["steps"], LOGIT_TOL)
        np.testing.assert_array_equal(got["steps"].argmax(-1),
                                      ref["tokens"])
        np.testing.assert_array_equal(got["prefill"].argmax(-1),
                                      ref["prefill"].argmax(-1))


# ---------------------------------------------------------------------------
# (f) the dry step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(DRY))
def test_dry_step_matches_the_real_step(ran, name):
    _, _, _, _, ranks = ran
    for r in ranks:
        got = r["dry"][name]
        assert got["seq"] and got["ring"] == name.startswith("ring")
        dry, real = got["dry"], got["real"]
        assert dry["flops"] == real["flops"] > 0
        assert dry["calls"] == real["calls"]
        assert dry["coll_bytes"] == real["coll_bytes"]
        if name.startswith("ring"):
            assert real["calls"]["send_recv"] > 0
        assert real["memory"]["peak_bytes"] <= dry["memory"][
            "peak_bytes"] <= (1 + PEAK_TOL) * real["memory"]["peak_bytes"]


@pytest.mark.parametrize("knobs", [{}, {"ring": True},
                                   {"seq_parallel": False}])
def test_dry_trace_holds_the_residual_stream_cut(monkeypatch, knobs):
    """The residual stream that enters every block of a dry train step
    on rank 0 of a (2, 2) mesh is (B/2, S/2, d) under the sequence-
    parallel and ring plans, and (B/2, S, d) without the cut."""
    import torch
    from repro_torch.configs import get_config as tget
    from repro_torch.configs.base import RunConfig as TRun
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_dry_mesh
    from repro_torch.models.transformer import TransformerModel
    cfg = tget(LLAMA).smoke()
    run = TRun(model=cfg, seq_len=S, global_batch=B, kind="train")
    plan = steps.plan_for(run, make_dry_mesh((2, 2)), attn_impl="ref",
                          **knobs)
    seen = []
    orig = TransformerModel._train_layer

    def spy(self, li, p, x, *a, **kw):
        seen.append(tuple(x.shape))
        return orig(self, li, p, x, *a, **kw)

    monkeypatch.setattr(TransformerModel, "_train_layer", spy)
    steps.dry_step(run, plan, torch.float32)
    cut = knobs.get("seq_parallel", True)
    assert seen and set(seen) == {(B // 2, S // 2 if cut else S,
                                   cfg.d_model)}
