"""GSPMD's weight layouts on the port's ranks against the JAX package on
one device: the ``"q_heads"`` attention cut (``wq``/``wo`` by H/m
contiguous heads over "model", ``wk``/``wv`` whole) and FSDP (every
``embed`` dim over "data", gathered just before use, the gradients
reduce-scattered), with the in-place AdamW of the train step.

One ``gloo`` group of 4 CPU processes runs every case
(``_torch_dist.gspmd_cases``): the (2, 2) mesh, the (1, 2) and (2, 1)
meshes on each pair of ranks, the (1, 4) mesh and the (2, 2, 1) ("pod",
"data", "model") mesh.  The JAX side is the single-device model
(``jax.value_and_grad`` of ``loss_fn``, ``prefill`` and ``decode_step``),
as in tests/test_torch_launch_ranks.py: the JAX sharded steps fail under
JAX 0.9.0.

- Train: each rank's gradients within ``GRAD_TOL`` · (1 + |g|) of the
  JAX gradients cut to the rank; loss, ce and aux within ``LOSS_TOL``
  relative; two steps within ``STEP_TOL`` of one device's plain steps,
  and the same global norm (``NORM_TOL`` relative).  Cases: FSDP on
  (2, 1) (granite-8b's ``embed: ("data",)`` override), with 2
  microbatches, with the heads, the groups and the forced ``"q_heads"``
  cut on (2, 2), and with ZeRO-1 on (2, 2, 1); ``"q_heads"`` forced on
  (1, 2) (no smoke config picks it on 2 ranks: it needs H even with the
  kv heads and G odd), and picked by the plan on (1, 4) for G 6 (each
  rank's 3 heads inside one group) and for G 2 with 3 heads a rank (the
  heads do not nest: each reads its own kv head).
- Prefill and decode: each rank's rows prefilled under the prefill plan,
  ``shard_decode_state``, 4 decode steps teacher-forced by JAX's greedy
  tokens: logits within ``LOGIT_TOL`` of JAX's rows, and every step's
  greedy token JAX's.  Cases: FSDP on (2, 1), FSDP with tp and with kvp
  ``"q_heads"`` on (2, 2), kvp ``"q_heads"`` at G 2 on (1, 2), dp
  ``"q_heads"`` at G 6 and with heads that do not nest on (1, 4).
- The in-place AdamW (``adamw_update_``) equals ``adamw_update`` bit for
  bit, in the params' and moments' own storage.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_helpers import LOGIT_TOL, close

from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data import synthetic_batches
from repro.models.api import build_model

GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
LOSS_TOL = 1e-5  # relative: loss, ce, aux
STEP_TOL = 2e-4  # params after each step against one device's
NORM_TOL = 1e-5  # relative: the global norm against one device's
STEPS = 2  # train steps
DECODE_STEPS = 4
B, S = 4, 16
# the rows of a case whose microbatches split 4 ranks' rows: 2 each
BATCH = {"fsdp_zero_pod_microbatched": 8}

GRANITE = "granite-8b"  # carries FSDP's embed: ("data",) override
LLAMA = "llama2-7b"
G6 = {"n_heads": 12, "n_kv_heads": 2, "head_dim": 32}  # 3 heads a rank
G2 = {"n_heads": 12, "n_kv_heads": 6, "head_dim": 32}  # heads cross groups
GQA = {"n_kv_heads": 2}  # 4 heads, G 2
# name: (mesh, config, replace, microbatches, zero_pod, forced attn cut,
#        expected attn cut, FSDP)
TRAIN = {
    "fsdp": ((2, 1), GRANITE, {}, None, False, None, "whole", True),
    "fsdp_microbatched": ((2, 1), GRANITE, {}, 2, False, None, "whole",
                          True),
    "fsdp_tp": ((2, 2), GRANITE, {}, None, False, None, "heads", True),
    "fsdp_groups": ((2, 2), GRANITE, {"n_kv_heads": 1}, None, False, None,
                    "groups", True),
    "fsdp_q_heads": ((2, 2), GRANITE, {}, None, False, "q_heads",
                     "q_heads", True),
    "fsdp_zero_pod": ((2, 2, 1), GRANITE, {}, None, True, None, "whole",
                      True),
    "fsdp_zero_pod_microbatched": ((2, 2, 1), GRANITE, {}, 2, True, None,
                                   "whole", True),
    "q_heads": ((1, 2), LLAMA, GQA, None, False, "q_heads", "q_heads",
                False),
    "q_heads_g6": ((1, 4), LLAMA, G6, None, False, None, "q_heads", False),
    "q_heads_apart": ((1, 4), LLAMA, G2, None, False, None, "q_heads",
                      False),
}
# name: (mesh, config, replace, decode scheme asked for, scheme, attn cut,
#        FSDP, lens)
PREFILL = {
    "fsdp": ((2, 1), GRANITE, {}, None, "tp", "whole", True,
             [37, 1, 53, 20]),
    "fsdp_tp": ((2, 2), GRANITE, {}, None, "tp", "heads", True,
                [37, 1, 53, 20]),
    "fsdp_kvp": ((2, 2), GRANITE, {}, "kvp", "kvp", "q_heads", True,
                 [29, 44, 3, 64]),
    "kvp_q_heads": ((1, 2), LLAMA, GQA, "kvp", "kvp", "q_heads", False,
                    [29, 44, 3, 64]),
    "dp_q_heads_g6": ((1, 4), LLAMA, G6, "dp", "dp", "q_heads", False,
                      [37, 1, 53, 20]),
    "dp_q_heads_apart": ((1, 4), LLAMA, G2, "dp", "dp", "q_heads", False,
                         [29, 44, 3, 64]),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _train_ref(name, seed):
    mesh, config, repl, mb, zp, attn, _, _ = TRAIN[name]
    cfg = get_config(config).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    batch = next(synthetic_batches(BATCH.get(name, B), S, cfg.vocab_size,
                                   seed=seed, cfg=cfg))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jb), has_aux=True))(params)
    case = dict(mesh=mesh, config=config, replace=repl, batch=batch,
                microbatches=mb, zero_pod=zp, attn=attn, params=_np(params),
                grads=_np(grads), steps=STEPS)
    return case, dict(loss=float(loss), ce=float(parts["ce"]),
                      aux=float(parts["aux"]))


def _prefill_ref(name, seed):
    mesh, config, repl, scheme, _, _, _, lens = PREFILL[name]
    cfg = get_config(config).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    Sp = max(lens)
    tokens = rng.integers(0, cfg.vocab_size, (len(lens), Sp)).astype(
        np.int32)
    lens = np.asarray(lens, np.int32)
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
    ref["greedy"] = np.stack(forced[1:] + [np.asarray(tok)])
    case = dict(mesh=mesh, config=config, replace=repl, tokens=tokens,
                lens=lens, steps=DECODE_STEPS, scheme=scheme,
                forced=np.stack(forced), params=_np(params))
    return case, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    train, prefill, refs = {}, {}, {}
    for i, name in enumerate(TRAIN):
        train[name], refs[f"train/{name}"] = _train_ref(name, 40 + i)
    for i, name in enumerate(PREFILL):
        prefill[name], refs[f"prefill/{name}"] = _prefill_ref(name, 60 + i)
    got = run_ranks(tmp_path_factory.mktemp("gspmd"), "gspmd_cases",
                    {"train": train, "prefill": prefill}, (2, 2),
                    timeout=600)
    return refs, got


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_grads_match_jax(ranks, name):
    refs, got = ranks
    ref = refs[f"train/{name}"]
    for r in got:
        c = r[f"train/{name}"]
        assert c["grad_err"] <= GRAD_TOL, (name, c["grad_err"])
        for k in ("loss", "ce", "aux"):
            assert abs(c[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, c)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_device(ranks, name):
    _, got = ranks
    for r in got:
        c = r[f"train/{name}"]
        assert max(c["param_err"]) <= STEP_TOL, c["param_err"]
        close(c["gnorm"], c["one_gnorm"], NORM_TOL)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_layout(ranks, name):
    """The cut each rank trains under, and what it holds: half the
    params under FSDP on 2 data ranks (a little more: the whole ``wk``/
    ``wv`` of "q_heads" layers, cut over "data" only), and under ZeRO-1
    a quarter of the moments ("pod" x "data")."""
    mesh, _, _, mb, zp, _, attn, fsdp = TRAIN[name]
    _, got = ranks
    for r in got:
        c = r[f"train/{name}"]
        assert set(c["attn"]) == {attn}
        assert tuple(c["fsdp"]) == (("data",) if fsdp else ())
        assert c["microbatches"] == (mb or 1)
        ranks_over_weights = mesh[-2] * mesh[-1] if fsdp else mesh[-1]
        assert c["param_frac"] <= 1.0 / ranks_over_weights + 0.25
        if fsdp and mesh[-1] == 1:
            assert c["param_frac"] == pytest.approx(0.5)
        if zp:
            assert c["mu_frac"] == pytest.approx(0.25)


@pytest.mark.parametrize("name", [n for n, c in TRAIN.items() if c[-1]])
def test_fsdp_gathers_and_reduce_scatters(ranks, name):
    """Each FSDP step gathers every cut leaf in the forward and
    reduce-scatters its gradient once per microbatch, and sums no FSDP
    gradient over "data" by an all-reduce."""
    _, got = ranks
    mb = TRAIN[name][3] or 1
    for r in got:
        calls = r[f"train/{name}"]["calls"]
        assert calls.get("all_gather", 0) > 0
        assert calls.get("reduce_scatter", 0) > 0
        assert calls["reduce_scatter"] % (mb * STEPS) == 0


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_and_decode_logits_match_jax(ranks, name):
    refs, got = ranks
    ref = refs[f"prefill/{name}"]
    for r in got:
        c = r[f"prefill/{name}"]
        lo = c["row0"] * c["rows"]
        rows = slice(lo, lo + c["rows"])
        close(c["prefill"], ref["prefill"][rows], LOGIT_TOL)
        close(c["steps"], ref["steps"][:, rows], LOGIT_TOL)
        np.testing.assert_array_equal(c["steps"].argmax(-1),
                                      ref["greedy"][:, rows])


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_layout(ranks, name):
    """The plan's cut, the FSDP axes and the rank's ``wq``: H/m heads
    unless whole, its embed rows halved over 2 data ranks."""
    mesh, config, repl, _, scheme, attn, fsdp, _ = PREFILL[name]
    cfg = get_config(config).smoke().replace(**repl)
    _, got = ranks
    for r in got:
        c = r[f"prefill/{name}"]
        assert c["scheme"] == scheme
        assert set(c["attn"]) == {attn}
        assert tuple(c["fsdp"]) == (("data",) if fsdp else ())
        m = mesh[-1] if attn != "whole" else 1
        d = cfg.d_model // (mesh[0] if fsdp else 1)
        assert c["wq"] == (d, cfg.n_heads // m, cfg.resolved_head_dim)


def _adamw_upd(g, m, v, p, count, lr_t, b1=0.9, b2=0.95, eps=1e-8,
               weight_decay=0.1):
    """The functional AdamW of PR 24 for one leaf, as written there
    (the JAX package's order and casts): (p', m', v')."""
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    g32 = g.float()
    m32 = b1 * m.float() + (1 - b1) * g32
    v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
    mhat = m32 / c1
    vhat = v32 / c2
    step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
    return ((p - lr_t * step.to(p.dtype)).to(p.dtype), m32.to(m.dtype),
            v32.to(v.dtype))


@pytest.mark.parametrize("moments", ["f32", "bf16"])
@pytest.mark.parametrize("schedule", [False, True])
def test_adamw_in_place_equals_adamw_update(schedule, moments):
    """``adamw_update_`` writes the numbers of the functional AdamW (its
    arithmetic as PR 24 wrote it, ``_adamw_upd``), bit for bit, into the
    storage the params and moments already have (3 steps; bf16 params
    with the bf16 moments); ``adamw_update`` gives the same numbers in
    new trees and leaves its arguments as they are."""
    from repro_torch.training.optimizer import (adamw_init, adamw_update,
                                                adamw_update_,
                                                cosine_schedule)
    from repro_torch.utils.tree import tree_leaves, tree_map
    rng = np.random.default_rng(5)
    dt = torch.float32 if moments == "f32" else torch.bfloat16
    params = {"w": torch.from_numpy(rng.standard_normal((7, 5))).to(dt),
              "b": [torch.from_numpy(rng.standard_normal(5)).to(dt)]}
    lr = cosine_schedule(1e-2, 2, 10) if schedule else 1e-2
    ref = [list(x) for x in zip(*[tree_leaves(t) for t in (
        params, adamw_init(params).mu, adamw_init(params).nu)])]
    p_a, s_a = params, adamw_init(params)
    p_b = tree_map(torch.clone, params)
    s_b = adamw_init(p_b)
    ptrs = [x.data_ptr() for x in tree_leaves((p_b, s_b.mu, s_b.nu))]
    for i in range(3):
        g = tree_map(lambda x: torch.from_numpy(rng.standard_normal(
            tuple(x.shape))).to(dt), params)
        count = torch.tensor(i + 1, dtype=torch.int32)
        lr_t = lr(count) if schedule else torch.tensor(lr)
        ref = [_adamw_upd(gl, m, v, p, count, lr_t)
               for gl, (p, m, v) in zip(tree_leaves(g), ref)]
        before = [x.clone() for x in tree_leaves((p_a, s_a.mu, s_a.nu))]
        p_a2, s_a2 = adamw_update(g, s_a, p_a, lr=lr)
        assert all(torch.equal(x, y) for x, y in zip(
            before, tree_leaves((p_a, s_a.mu, s_a.nu))))
        p_a, s_a = p_a2, s_a2
        s_b = adamw_update_(g, s_b, p_b, lr=lr)
        want = [x for trio in zip(*ref) for x in trio]
        for got in ((p_a, s_a.mu, s_a.nu), (p_b, s_b.mu, s_b.nu)):
            leaves = tree_leaves(got)
            assert all(x.dtype == y.dtype and torch.equal(x, y)
                       for x, y in zip(leaves, want))
        assert int(s_b.count) == int(s_a.count) == i + 1
    assert [x.data_ptr() for x in tree_leaves((p_b, s_b.mu, s_b.nu))] == ptrs
