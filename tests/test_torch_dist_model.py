"""The smoke models' decode step across ranks against the JAX package's
single-device step.

The JAX package's own tests hold its sharded serve step to its
single-device one; here the port's step under each scheme of
``plan_for`` — tp (heads, MLP columns and the vocab over "model"), dp
(the ``swa`` variant's windowed layers, with q-head groups split or
replicated), expert parallelism on the MoE smoke model, and kvp
(pages striped, K1's plain version per stripe and K2's over every
rank's splits) — runs on 2- and 4-rank ``gloo`` groups
after a prefill under the plan and ``shard_decode_state``, and its
prefill logits, every step's logits (``LOGIT_TOL``) and greedy tokens
(equal) are held against the JAX model's ``prefill`` and ``decode_step``
(``impl="ref"``) on one device with the same weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_dist import run_ranks
from _torch_helpers import LOGIT_TOL, close

from repro.configs import get_config
from repro.configs.base import RunConfig
from repro.models.api import build_model

STEPS = 6
# the JAX references: name -> (config, replace, prompt lengths); smoke
# configs: 4 heads, d_model 256, head_dim 64, vocab 512, page 8, 2 layers
REFS = {
    "llama": ("llama2-7b", {}, [37, 1, 53]),
    "vocab_whole": ("llama2-7b", {"vocab_size": 511}, [37, 20, 53]),
    "gqa": ("llama2-7b", {"n_kv_heads": 2}, [29, 44, 3]),
    "swa": ("llama2-7b", {"layer_pattern": "W", "window": 64},
            [70, 33, 61]),
    "swa_gqa": ("llama2-7b", {"layer_pattern": "W", "window": 64,
                              "n_kv_heads": 2}, [70, 12, 66]),
    "mixed": ("llama2-7b", {"layer_pattern": "AW", "window": 64},
              [70, 40, 9]),
    # expert parallelism (4 experts, top 2, tied embeddings): at 1.25 on
    # a wave with no padding (per-rank capacity = the single device's on
    # one data rank), dropless on a padded one
    "moe": ("granite-moe-1b-a400m", {"moe_ep": True}, [24, 24, 24]),
    "moe_dropless": ("granite-moe-1b-a400m",
                     {"moe_ep": True, "moe_capacity": 0.0}, [24, 7, 15]),
}
# name: (mesh, reference, scheme asked for, scheme the plan picks)
CASES = {
    "tp": ((1, 2), "llama", None, "tp"),
    "tp_vocab_whole": ((1, 2), "vocab_whole", None, "tp"),
    "tp_gqa": ((1, 2), "gqa", None, "tp"),
    "kvp": ((1, 2), "llama", "kvp", "kvp"),
    "dp_swa": ((1, 2), "swa", "kvp", "dp"),
    "dp_swa_groups": ((1, 2), "swa_gqa", "dp", "dp"),
    "mixed_tp": ((1, 2), "mixed", None, "tp"),
    "ep": ((1, 2), "moe", None, "tp"),
    "ep_dropless": ((1, 2), "moe_dropless", None, "tp"),
    "kvp4": ((1, 4), "llama", "kvp", "kvp"),
    "tp4": ((1, 4), "llama", None, "tp"),
    "kvp4_gqa": ((1, 4), "gqa", None, "kvp"),
    "ep4": ((1, 4), "moe_dropless", None, "tp"),
}


def _jax_ref(key, seed):
    config, repl, lens = REFS[key]
    cfg = get_config(config).smoke().replace(**repl)
    model = build_model(cfg)
    params = model.init_params(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    B, S = len(lens), max(lens)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    run = RunConfig(model=cfg, seq_len=S + STEPS, global_batch=B,
                    kind="decode")
    state = model.init_decode_state(run)
    pps = state["tables"].shape[2]
    state["tables"] = jnp.arange(B * pps, dtype=jnp.int32).reshape(B, 1, pps)
    prefill = jax.jit(model.prefill, static_argnames=("impl",))
    decode = jax.jit(model.decode_step, static_argnames=("impl",))
    logits, state = prefill(params, jnp.asarray(tokens), state,
                            lens=jnp.asarray(lens), impl="jnp")
    ref = {"prefill": np.asarray(logits)}
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps, toks = [], [np.asarray(tok)]
    for _ in range(STEPS):
        logits, state = decode(params, tok, state, impl="ref")
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    ref["steps"], ref["tokens"] = np.stack(steps), np.stack(toks)
    case = dict(config=config, replace=repl, tokens=tokens, lens=lens,
                steps=STEPS, params=jax.tree_util.tree_map(np.asarray, params))
    return case, ref


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    refs, inputs = {}, {}
    for i, key in enumerate(REFS):
        inputs[key], refs[key] = _jax_ref(key, i)
    by_mesh = {}
    for name, (mesh, key, scheme, _) in CASES.items():
        by_mesh.setdefault(mesh, {})[name] = dict(inputs[key], scheme=scheme)
    ranks = {mesh: run_ranks(tmp_path_factory.mktemp("model"),
                             "model_cases", {"cases": cases}, mesh)
             for mesh, cases in by_mesh.items()}
    return refs, ranks


def _ranks(served, name):
    refs, ranks = served
    return refs[CASES[name][1]], ranks[CASES[name][0]]


@pytest.mark.parametrize("name", list(CASES))
def test_plan_scheme(served, name):
    _, ranks = _ranks(served, name)
    assert {r[f"{name}/scheme"] for r in ranks} == {CASES[name][3]}


@pytest.mark.parametrize("name", list(CASES))
def test_prefill_logits_match_jax(served, name):
    ref, ranks = _ranks(served, name)
    for r in ranks:
        close(r[f"{name}/prefill"], ref["prefill"], LOGIT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_decode_logits_match_jax_single_device(served, name):
    ref, ranks = _ranks(served, name)
    for r in ranks:
        close(r[f"{name}/steps"], ref["steps"], LOGIT_TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_greedy_tokens_equal_jax(served, name):
    ref, ranks = _ranks(served, name)
    for r in ranks:
        np.testing.assert_array_equal(r[f"{name}/tokens"], ref["tokens"])


@pytest.mark.parametrize("name", ["tp", "tp_gqa", "tp4"])
def test_tp_pools_hold_the_rank_s_kv_heads(served, name):
    _, ranks = _ranks(served, name)
    config, repl, _ = REFS[CASES[name][1]]
    cfg = get_config(config).smoke().replace(**repl)
    m = CASES[name][0][1]
    assert {r[f"{name}/pool_heads"] for r in ranks} == {cfg.n_kv_heads // m}


@pytest.mark.parametrize("name", ["tp", "kvp", "dp_swa_groups", "ep"])
def test_init_params_under_the_plan_is_the_cut_of_the_whole_draw(served,
                                                                  name):
    """``init_params(gen, plan=)`` draws each entry whole in the order of
    the unsharded draw and keeps the rank's cut: every rank ends with
    the pieces of the same weights."""
    _, ranks = _ranks(served, name)
    assert all(r[f"{name}/init_equal"] for r in ranks)
    assert ranks[0][f"{name}/init_shapes"] == ranks[1][f"{name}/init_shapes"]
