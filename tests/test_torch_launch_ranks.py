"""The train and prefill steps of ``launch.steps`` across ranks against
the JAX package on one device.

One ``gloo`` group of 4 CPU processes runs every case
(``_torch_dist.launch_cases``): the (2, 2) mesh over all four, and the
(1, 2) and (2, 1) meshes on each pair of ranks.  The JAX side: the JAX
model's ``loss_fn`` gradients by ``jax.value_and_grad`` on the whole
batch (the JAX train step under a mesh fails under JAX 0.9.0, so the
reference is the single-device function, as the port's training tests
hold it), and the JAX model's ``prefill`` and ``decode_step``
(``impl="jnp"``/``"ref"``) on one device.

- Train: each rank's gradients (``train_grads``: its heads, ``d_ff``
  columns and vocab slice, the gradients summed over the batch axes)
  within 1e-4 · (1 + |g|) of the JAX gradients cut to the rank; the loss,
  ce and aux within 1e-5 relative; two steps of ``build_train_step``
  within 2e-4 of one device's plain step, and the same global norm.
  Cases: data (2, 1), tensor (1, 2) with the heads cut, the q-head groups
  cut and a vocab that stays whole, a windowed model, (2, 2), a masked
  batch (the sum and the weight reduced apart), microbatches under data
  parallelism, and smoke granite-moe under data parallelism (the aux
  loss's statistics reduced before the product).
- Prefill: each rank's rows prefilled under the prefill plan into pools
  of its decode layout's kv heads, then ``shard_decode_state`` and 4
  decode steps: logits within ``LOGIT_TOL`` of JAX's rows, under (2, 1),
  (1, 2) tp and kvp, and (2, 2) tp, kvp and dp (windowed).
- The collectives under autograd: under ``no_grad`` each is the plain
  collective bit for bit; f's backward sums, g's and the vocab gather's
  pass the rank's share.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_helpers import LOGIT_TOL, close

from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.data import synthetic_batches
from repro.models.api import build_model

GRAD_TOL = 1e-4  # |g_port - g_jax| <= GRAD_TOL * (1 + |g_jax|)
LOSS_TOL = 1e-5  # relative: loss, ce, aux
STEP_TOL = 2e-4  # params after each step against one device's
STEPS = 2  # train steps
DECODE_STEPS = 4
B, S = 4, 16

LLAMA = "llama2-7b"
MOE = "granite-moe-1b-a400m"
# name: (mesh, config, replace, masked, microbatches, expected attn cut)
TRAIN = {
    "data": ((2, 1), LLAMA, {}, False, None, "whole"),
    "tp": ((1, 2), LLAMA, {}, False, None, "heads"),
    "tp_groups": ((1, 2), LLAMA, {"n_kv_heads": 1}, False, None, "groups"),
    "tp_vocab_whole": ((1, 2), LLAMA, {"vocab_size": 511}, False, None,
                       "heads"),
    "tp_window": ((1, 2), LLAMA, {"layer_pattern": "W", "window": 8}, False,
                  None, "heads"),
    "data_tp": ((2, 2), LLAMA, {}, False, None, "heads"),
    "masked_data": ((2, 1), LLAMA, {}, True, None, "whole"),
    "masked_data_tp": ((2, 2), LLAMA, {}, True, None, "heads"),
    "microbatched_data": ((2, 1), LLAMA, {}, False, 2, "whole"),
    "moe_data": ((2, 1), MOE, {"moe_capacity": 0.0}, False, None, "whole"),
}
# name: (mesh, config, replace, decode scheme asked for, scheme, lens)
PREFILL = {
    "data": ((2, 1), LLAMA, {}, None, "tp", [37, 1, 53, 20]),
    "tp": ((1, 2), LLAMA, {}, None, "tp", [37, 1, 53, 20]),
    "kvp": ((1, 2), LLAMA, {}, "kvp", "kvp", [29, 44, 3, 64]),
    "data_tp": ((2, 2), LLAMA, {}, None, "tp", [37, 1, 53, 20]),
    "data_kvp": ((2, 2), LLAMA, {}, "kvp", "kvp", [29, 44, 3, 64]),
    "data_dp_window": ((2, 2), LLAMA, {"layer_pattern": "W", "window": 64},
                       "kvp", "dp", [70, 33, 61, 9]),
}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _train_ref(name, seed):
    mesh, config, repl, masked, mb, _ = TRAIN[name]
    cfg = get_config(config).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    batch = next(synthetic_batches(B, S, cfg.vocab_size, seed=seed, cfg=cfg))
    batch = {k: np.asarray(v) for k, v in batch.items()}
    if masked:
        # rows of very different weight: a mean of the ranks' means is
        # not the mean over the weight
        mask = np.zeros((B, S), np.float32)
        mask[0, :3] = mask[1, :2] = 1.0
        mask[2:] = np.random.default_rng(seed).random((2, S)) < 0.9
        batch["mask"] = mask
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, parts), grads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_fn(p, jb), has_aux=True))(params)
    case = dict(mesh=mesh, config=config, replace=repl, batch=batch,
                microbatches=mb, params=_np(params), grads=_np(grads),
                steps=STEPS)
    ref = dict(loss=float(loss), ce=float(parts["ce"]),
               aux=float(parts["aux"]))
    if masked or config == MOE:
        # the per-half values a rank would see on its own rows
        halves = []
        for rows in (slice(0, B // 2), slice(B // 2, B)):
            hb = {k: v[rows] for k, v in jb.items()}
            halves.append({k: float(v) for k, v in jax.jit(
                lambda p: model.loss_fn(p, hb)[1])(params).items()})
        ref["halves"] = halves
    return case, ref


def _prefill_ref(name, seed):
    mesh, config, repl, scheme, _, lens = PREFILL[name]
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
    case = dict(mesh=mesh, config=config, replace=repl, tokens=tokens,
                lens=lens, steps=DECODE_STEPS, scheme=scheme,
                forced=np.stack(forced), params=_np(params))
    return case, ref


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    train, prefill, refs = {}, {}, {}
    for i, name in enumerate(TRAIN):
        train[name], refs[f"train/{name}"] = _train_ref(name, i)
    for i, name in enumerate(PREFILL):
        prefill[name], refs[f"prefill/{name}"] = _prefill_ref(name, 20 + i)
    ranks = run_ranks(tmp_path_factory.mktemp("launch"), "launch_cases",
                      {"train": train, "prefill": prefill}, (2, 2),
                      timeout=600)
    return refs, ranks


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_grads_match_jax(launched, name):
    refs, ranks = launched
    ref = refs[f"train/{name}"]
    for r in ranks:
        got = r[f"train/{name}"]
        assert got["grad_err"] <= GRAD_TOL, (r, got["grad_err"])
        for k in ("loss", "ce", "aux"):
            assert abs(got[k] - ref[k]) <= LOSS_TOL * abs(ref[k]), (k, got)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_match_one_device(launched, name):
    _, ranks = launched
    for r in ranks:
        got = r[f"train/{name}"]
        assert max(got["param_err"]) <= STEP_TOL, got["param_err"]
        close(got["gnorm"], got["one_gnorm"], 1e-5)


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_plan_cut(launched, name):
    mesh, config, repl, _, mb, attn = TRAIN[name]
    _, ranks = launched
    for r in ranks:
        got = r[f"train/{name}"]
        assert set(got["attn"]) == {attn}
        assert got["microbatches"] == (mb or 1)
        assert got["vocab"] == (mesh[1] > 1 and "vocab_size" not in repl)


@pytest.mark.parametrize("name", ["masked_data", "moe_data"])
def test_data_parallel_losses_are_not_means_of_the_ranks(launched, name):
    """The traps the data-parallel step avoids: the masked ce is not the
    mean of the two halves' masked means, and the MoE aux loss not the
    mean of the halves' aux losses; the step's equal the whole batch's
    (``test_train_grads_match_jax``)."""
    refs, _ = launched
    ref = refs[f"train/{name}"]
    key = "ce" if name == "masked_data" else "aux"
    mean = sum(h[key] for h in ref["halves"]) / 2
    assert abs(mean - ref[key]) > 100 * LOSS_TOL * abs(ref[key]), (
        mean, ref[key])


def _rows(r, name):
    got = r[f"prefill/{name}"]
    lo = got["row0"] * got["rows"]
    return got, slice(lo, lo + got["rows"])


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_logits_match_jax(launched, name):
    refs, ranks = launched
    ref = refs[f"prefill/{name}"]
    for r in ranks:
        got, rows = _rows(r, name)
        close(got["prefill"], ref["prefill"][rows], LOGIT_TOL)


@pytest.mark.parametrize("name", list(PREFILL))
def test_decode_after_the_sharded_prefill_matches_jax(launched, name):
    refs, ranks = launched
    ref = refs[f"prefill/{name}"]
    for r in ranks:
        got, rows = _rows(r, name)
        assert got["scheme"] == PREFILL[name][4]
        close(got["steps"], ref["steps"][:, rows], LOGIT_TOL)


@pytest.mark.parametrize("name", list(PREFILL))
def test_prefill_rows_and_pools(launched, name):
    """Each rank prefills only its rows (B / data), into pools of its
    decode layout's kv heads (its share under tp: 4 smoke heads)."""
    mesh, config, repl, scheme, sch, lens = PREFILL[name]
    _, ranks = launched
    rows = {r[f"prefill/{name}"]["row0"] for r in ranks}
    assert rows == set(range(mesh[0]))
    for r in ranks:
        got = r[f"prefill/{name}"]
        assert got["rows"] == len(lens) // mesh[0]
        assert got["pool_heads"] == (4 // mesh[1] if sch == "tp" else 4)


def test_collectives_under_autograd(launched):
    _, ranks = launched
    w = np.arange(30, dtype=np.float32).reshape(3, 10)
    for r in ranks:
        c = r["coll"]
        assert c["nograd_equal"]
        # loss = Σ w · [x_0 · 1 | x_1 · 2]: f sums the ranks' shares
        close(c["copy_gather_grad"], w[:, :5] + 2 * w[:, 5:], 0)
        close(c["reduce_grad"], w[:, :5], 0)
