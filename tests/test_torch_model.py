"""PyTorch port: smoke llama2-7b with the JAX weights (``params_from_numpy``)
gives the JAX ``TransformerModel``'s prefill logits and 4 decode-step
logits (reference run with ``impl="ref"``), at ``LOGIT_TOL``, on the
port's kernel path (split-K forced, so the combine runs) and its plain
oracle path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.models.api import build_model as jbuild
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.models import build_model, params_from_numpy

from _torch_helpers import LOGIT_TOL, close, t


def test_build_model_families():
    build_model(tget_smoke("llama2-7b"))
    build_model(tget_smoke("granite-8b"))  # dense GQA
    with pytest.raises(UnsupportedFeature):
        build_model(tget_smoke("olmoe-1b-7b"))
    with pytest.raises(UnsupportedFeature):
        build_model(tget_smoke("recurrentgemma-9b"))
    with pytest.raises(EngineConfigError):
        build_model(tget_smoke("llama2-7b").replace(family="nope"))


def test_param_spec_matches_reference_layout():
    cfg = get_smoke("llama2-7b")
    jp = jbuild(cfg).init_params(jax.random.PRNGKey(0))
    port = build_model(tget_smoke("llama2-7b")).init_params(
        torch.Generator().manual_seed(0))
    conv = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), conv)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), port))
    wq = port["layers"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - 0.02) < 2e-3  # the reference's N(0, 0.02²)
    assert torch.equal(port["ln_f"]["scale"], torch.ones_like(wq[:, 0, 0]))


@pytest.mark.parametrize("name", ["granite-8b", "nemotron-4-15b"])
def test_other_dense_configs_prefill_logits_match_reference(name):
    """granite-8b: tied embeddings, GQA; nemotron-4-15b: LayerNorm with a
    bias, squared-ReLU MLP."""
    cfg = get_smoke(name)
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(1))
    tm = build_model(tget_smoke(name))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    rng = np.random.default_rng(1)
    B, pps = 2, 4
    lens = np.array([19, 11], np.int32)
    tokens = rng.integers(0, cfg.vocab_size, (B, 19)).astype(np.int32)
    tables = np.arange(B * pps, dtype=np.int32).reshape(B, 1, pps)
    pool = (cfg.n_layers, B * pps, cfg.page_size, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    jl, _ = jm.prefill(jp, jnp.asarray(tokens),
                       {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
                        "k_pages": jnp.zeros(pool),
                        "v_pages": jnp.zeros(pool)},
                       lens=jnp.asarray(lens), impl="ref")
    st = {"pos": t(lens), "tables": t(tables), "k_pages": torch.zeros(pool),
          "v_pages": torch.zeros(pool)}
    logits, _ = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                           impl="kernel")
    close(logits, jl, LOGIT_TOL)


def test_prefill_and_decode_logits_match_reference():
    cfg = get_smoke("llama2-7b")
    jm = jbuild(cfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    tm = build_model(tget_smoke("llama2-7b"))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")

    rng = np.random.default_rng(0)
    B, P = 3, cfg.page_size
    lens = np.array([13, 30, 22], np.int32)
    S, pps = int(lens.max()), 8  # room for the prompt + 4 decode steps
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    num_pages = B * pps + 2
    tables = rng.permutation(num_pages)[:B * pps].reshape(B, 1, pps)
    tables = tables.astype(np.int32)
    pool = (cfg.n_layers, num_pages, P, cfg.n_kv_heads,
            cfg.resolved_head_dim)

    jst = {"pos": jnp.asarray(lens), "tables": jnp.asarray(tables),
           "k_pages": jnp.zeros(pool), "v_pages": jnp.zeros(pool)}
    jl, jst = jm.prefill(jp, jnp.asarray(tokens), jst,
                         lens=jnp.asarray(lens), impl="ref")
    ref = [np.asarray(jl)]
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    steps = []
    for _ in range(4):
        steps.append(nxt)
        jl, jst = jm.decode_step(jp, jnp.asarray(nxt), jst, impl="ref")
        ref.append(np.asarray(jl))
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)

    for impl, knobs in (("kernel", dict(pages_per_block=2, num_splits=2)),
                        ("ref", {})):
        st = {"pos": t(lens), "tables": t(tables),
              "k_pages": torch.zeros(pool), "v_pages": torch.zeros(pool)}
        logits, st = tm.prefill(tp, t(tokens).long(), st, lens=t(lens),
                                impl=impl)
        close(logits, ref[0], LOGIT_TOL)
        for i, tok in enumerate(steps):  # teacher-forced: same inputs
            logits, st = tm.decode_step(tp, t(tok).long(), st, impl=impl,
                                        **knobs)
            close(logits, ref[i + 1], LOGIT_TOL)
        np.testing.assert_array_equal(st["pos"].numpy(), lens + 4)
    np.testing.assert_allclose(st["k_pages"].numpy(),
                               np.asarray(jst["k_pages"]), rtol=1e-5,
                               atol=1e-5)
