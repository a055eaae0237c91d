"""Weight-stationary decode (``plan_for(..., ws_decode=True)``, JAX's
``ws_decode``) on the port's ranks against the JAX package on one device.

Under the ws plan a decode step has no batch axes (every rank holds every
row: kvp stripes the pages over every mesh axis) and the activations are
cut along ``embed`` over "data" (``TPLayout.act_embed``): the FSDP weights
stay where they are, a view of its slice stands in for a whole weight,
and the f32 partials of every product that contracts ``embed`` are
all-reduced over "data".

One ``gloo`` group of 4 CPU processes runs every case
(``_torch_dist.ws_cases``): each rank prefills its rows under the prefill
plan, ``shard_decode_state`` gathers the rows into the ws plan, then 4
decode steps run teacher-forced by the single-device JAX ``decode_step``'s
greedy tokens (the JAX sharded path fails under JAX 0.9.0 and is not the
reference): logits within ``LOGIT_TOL`` of JAX's, every greedy token
JAX's.  During the steps every collective's mesh axes are recorded: no
weight is gathered (``layers.gather_fsdp`` refuses, and no
``all_gather_dim`` runs over "data"), the only all-gathers are the kvp
merge's (one a layer, over every axis) and the ``"q_heads"`` cut's (one a
layer, over "model"), and the all-reduces over "data" are the norms',
the products' and the logits' partials, counted from the layers.
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

DECODE_STEPS = 4
GRANITE = "granite-8b"  # carries FSDP's embed: ("data",) override
MOE = "granite-moe-1b-a400m"  # whole weights, the experts over "model"
# dropless: each rank's prefill drops by its own rows' capacity (the JAX
# law) and JAX's counts the padding, so only dropless prefills are one
# device's; the ws decode routes every row on every rank
DROPLESS = {"moe_capacity": 0}
LLAMA = "llama2-7b"
SWA = {"layer_pattern": "W", "window": 16}  # the swa variant, cut to size
# name: (mesh, config, replace, decode scheme asked for, scheme, attn cut,
#        FSDP, lens)
CASES = {
    "fsdp_tp": ((2, 1), GRANITE, {}, None, "tp", "whole", True,
                [37, 1, 53, 20]),
    "fsdp_kvp": ((2, 1), GRANITE, {}, "kvp", "kvp", "whole", True,
                 [29, 44, 3, 64]),
    "fsdp_kvp_q_heads": ((2, 2), GRANITE, {}, "kvp", "kvp", "q_heads",
                         True, [29, 44, 3, 64]),
    "fsdp_pod": ((2, 2, 1), GRANITE, {}, "kvp", "kvp", "whole", True,
                 [37, 1, 53, 20]),
    "moe": ((2, 2), MOE, DROPLESS, None, "tp", "heads", False,
            [29, 44, 3, 64]),
    "moe_ep": ((2, 2), MOE, {**DROPLESS, "moe_ep": True}, None, "tp",
               "heads", False, [37, 1, 53, 20]),
    "swa_dp": ((2, 2), LLAMA, SWA, "dp", "dp", "q_heads", False,
               [37, 12, 53, 20]),
}


def _ref(name, seed):
    mesh, config, repl, scheme, _, _, _, lens = CASES[name]
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
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    steps, forced = [], []
    for _ in range(DECODE_STEPS):
        forced.append(np.asarray(tok))
        logits, state = decode(params, tok, state, impl="ref")
        steps.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    ref = {"steps": np.stack(steps),
           "greedy": np.stack(forced[1:] + [np.asarray(tok)])}
    case = dict(mesh=mesh, config=config, replace=repl, tokens=tokens,
                lens=lens, steps=DECODE_STEPS, scheme=scheme,
                forced=np.stack(forced),
                params=jax.tree_util.tree_map(np.asarray, params))
    return case, ref


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases, refs = {}, {}
    for i, name in enumerate(CASES):
        cases[name], refs[name] = _ref(name, 80 + i)
    got = run_ranks(tmp_path_factory.mktemp("ws"), "ws_cases", cases,
                    (2, 2), timeout=600)
    return refs, got


@pytest.mark.parametrize("name", list(CASES))
def test_ws_decode_logits_match_jax(ranks, name):
    """Every rank's logits of every row within ``LOGIT_TOL`` of the
    single-device JAX decode, and every step's greedy token JAX's."""
    refs, got = ranks
    ref = refs[name]
    for r in got:
        c = r[name]
        close(c["steps"], ref["steps"], LOGIT_TOL)
        np.testing.assert_array_equal(c["steps"].argmax(-1), ref["greedy"])


@pytest.mark.parametrize("name", list(CASES))
def test_ws_plan_and_rows(ranks, name):
    """The ws plan: no batch axes, kvp's stripes over every mesh axis,
    the activations cut over "data", FSDP's weight cut unchanged; the
    prefill's rows (half the batch: "data" holds 2 ranks) gathered by
    ``shard_decode_state`` into every row, striped under kvp."""
    mesh, config, repl, _, scheme, attn, fsdp, lens = CASES[name]
    names = (("pod", "data", "model") if len(mesh) == 3
             else ("data", "model"))
    _, got = ranks
    for r in got:
        c = r[name]
        assert c["scheme"] == scheme
        assert tuple(c["batch_axes"]) == ()
        assert tuple(c["kv_axes"]) == (names if scheme == "kvp" else ())
        assert tuple(c["act_embed"]) == ("data",)
        assert tuple(c["fsdp"]) == (("data",) if fsdp else ())
        assert set(c["attn"]) == {attn}
        assert c["moe"] == (("ep" if repl.get("moe_ep") else "cut")
                            if config == MOE else "whole")
        n_rows = 4 // (mesh[0] * mesh[1] if len(mesh) == 3 else mesh[0])
        assert c["prefill_rows"] == n_rows
        assert c["rows"] == len(lens)
        n = int(np.prod(mesh)) if scheme == "kvp" else 1
        assert c["table_shape"][:2] == (len(lens), 1)
        if scheme == "kvp":
            cfg = get_config(config).smoke().replace(**repl)
            pps = -(-(max(lens) + DECODE_STEPS) // cfg.page_size)
            assert c["table_shape"][2] == -(-pps // n)


def _data_reduces(cfg, c):
    """The all-reduces over "data" of one ws decode step, from the
    layers: per layer the two norms (one sum each for RMSNorm, two for
    LayerNorm) and the packed q/k/v partials, then the FFN's up
    partials (the MLP's ``wg``/``wu`` in one, or the MoE router's and the
    experts' in two); the final norm and the logits."""
    norm = 2 if cfg.norm == "layernorm" else 1
    ffn = 2 if cfg.is_moe else 1
    return cfg.n_layers * (2 * norm + 1 + ffn) + norm + 1


@pytest.mark.parametrize("name", list(CASES))
def test_ws_decode_gathers_no_weight(ranks, name):
    """During the ws steps no weight is gathered: no ``all_gather_dim``
    over "data" (and ``layers.gather_fsdp`` refused, in the ranks); the
    all-gathers are the kvp merge's, one a layer over every mesh axis,
    the ``"q_heads"`` cut's, one a layer over "model", and the vocab's
    over "model" when it is cut; the all-reduces over "data" are exactly
    the layers' partials (``_data_reduces``)."""
    mesh, config, repl, _, scheme, attn, _, _ = CASES[name]
    cfg = get_config(config).smoke().replace(**repl)
    _, got = ranks
    for r in got:
        c = r[name]
        calls = [(op, tuple(a)) for op, a in c["calls"]]
        c["kv_axes"] = tuple(c["kv_axes"])
        assert not [k for k in calls if k[0] in ("all_gather_dim",
                                                 "all_gather")
                    and "data" in k[1] and k[1] != tuple(c["kv_axes"])]
        kvp = DECODE_STEPS * cfg.n_layers if scheme == "kvp" else 0
        merges = [k for k in calls if k == ("all_gather", c["kv_axes"])]
        assert len(merges) == kvp
        vocab = [k for k in calls if k == ("all_gather", ("model",))]
        assert len(vocab) == DECODE_STEPS * c["vocab"]
        assert len([k for k in calls if k[0] == "all_gather"]) == (
            kvp + len(vocab))
        dims = [k for k in calls if k[0] == "all_gather_dim"]
        q_heads = DECODE_STEPS * cfg.n_layers if attn == "q_heads" else 0
        assert dims == [("all_gather_dim", ("model",))] * q_heads
        data = [k for k in calls if k == ("all_reduce", ("data",))]
        assert len(data) == DECODE_STEPS * _data_reduces(cfg, c)
        # EP's two exchanges a layer, over "model"
        ep = 2 * DECODE_STEPS * cfg.n_layers if repl.get("moe_ep") else 0
        assert [k for k in calls if k[0] == "all_to_all"] == [
            ("all_to_all", ("model",))] * ep
        assert not [k for k in calls if k[0] == "reduce_scatter"]


def test_ws_shard_decode_state_takes_every_row_or_a_prefill_s():
    """Under the ws plan ``shard_decode_state`` takes a state of every row
    as it is, gathers one of a prefill's rows (the 4-rank cases above),
    and refuses any other row count (``EngineConfigError``): here 3 rows
    of a batch of 4 on (2, 1), whose prefill would have held 2."""
    from repro_torch.configs import get_config as get_config_t
    from repro_torch.configs.base import RunConfig as RunConfigT
    from repro_torch.distributed.collectives import (dropped_batch_axes,
                                                     shard_decode_state)
    from repro_torch.errors import EngineConfigError
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import plan_for
    from repro_torch.models.api import build_model as build_model_t
    cfg = get_config_t(GRANITE).smoke()
    run = RunConfigT(model=cfg, seq_len=32, global_batch=4, kind="decode")
    model = build_model_t(cfg)
    plan = plan_for(run, Mesh((2, 1), rank=1), ws_decode=True)
    assert plan.batch_axes == () and dropped_batch_axes(plan) == ("data",)
    assert dropped_batch_axes(plan_for(run, Mesh((2, 1), rank=1))) == ()
    for rows, ok in ((4, True), (3, False)):
        lrun = RunConfigT(model=cfg, seq_len=32, global_batch=rows,
                          kind="decode")
        st = model.init_decode_state(lrun, device="cpu", plan=plan)
        if ok:
            assert shard_decode_state(st, plan)["pos"].shape == (rows,)
        else:
            with pytest.raises(EngineConfigError, match="rows"):
                shard_decode_state(st, plan)
