"""PyTorch port: the training substrate against the JAX package, on the CPU.

- the optimizer: ``adamw_update`` over 5 steps (a constant learning rate
  and a cosine schedule, f32 and bf16 moments), ``clip_by_global_norm``
  (clipped and not) and ``cosine_schedule`` at steps 0/10/55/100, all
  within ``OPT_TOL`` of the JAX functions on the same numpy inputs;
- the data: ``ByteTokenizer``, ``text_to_ids``, ``synthetic_batches`` and
  ``lm_batches`` equal to the JAX package's arrays, extras included;
- checkpoints: the round trip of a ``TrainState``, a missing key
  (``KeyError``) and a wrong shape (``ValueError``), and files that each
  package's ``restore`` reads from the other's ``save``;
- a JAX ``TrainState`` after 2 steps, carried across with
  ``train_state_from_numpy``, gives JAX's step-3 loss and grad norm;
- ``train_loop``: the loss falls on smoke granite-8b (JAX's own test) and
  the MoE aux stays finite as the loss falls;
- the launcher with ``--smoke --steps 3 --device cpu``, and the entry
  points' default device, the card, refused on this host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke
from repro.data import ByteTokenizer as JTokenizer
from repro.data import lm_batches as jlm_batches
from repro.data import synthetic_batches as jsynthetic
from repro.data import text_to_ids as jtext_to_ids
from repro.models.api import build_model as jbuild
from repro.training import TrainState as JTrainState
from repro.training import adamw_init as jadamw_init
from repro.training import adamw_update as jadamw_update
from repro.training import clip_by_global_norm as jclip
from repro.training import cosine_schedule as jcosine
from repro.training import make_train_step as jmake_train_step
from repro.training.checkpoint import restore as jrestore
from repro.training.checkpoint import save as jsave
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.data import (ByteTokenizer, lm_batches, synthetic_batches,
                              text_to_ids)
from repro_torch.errors import EngineConfigError
from repro_torch.launch import train as launch_train
from repro_torch.models import (build_model, params_from_numpy,
                                train_state_from_numpy)
from repro_torch.training import (TrainState, adamw_init, adamw_update,
                                  clip_by_global_norm, cosine_schedule,
                                  make_train_step, train_loop)
from repro_torch.training.checkpoint import restore, save
from repro_torch.training.loop import to_device
from repro_torch.utils.tree import tree_leaves, tree_map

from _torch_helpers import close, t

OPT_TOL = 1e-6  # the optimizer on identical inputs
STEP_TOL = 1e-5  # relative: a step's loss and grad norm after a carry-over


def _tree(rng):
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "b": {"x": rng.standard_normal((5,)).astype(np.float32),
                  "y": rng.standard_normal((2, 2)).astype(np.float32)}}


# -- the optimizer ----------------------------------------------------------------
@pytest.mark.parametrize("schedule", [False, True])
@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(schedule, moments):
    rng = np.random.default_rng(0)
    p0 = _tree(rng)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    tp = tree_map(t, p0)
    js, ts = jadamw_init(jp), adamw_init(tp)
    js = js._replace(mu=jax.tree_util.tree_map(
        lambda a: a.astype(moments), js.mu))
    ts = ts._replace(mu=tree_map(lambda a: a.to(getattr(torch, moments)),
                                 ts.mu))
    jlr = jcosine(0.1, 2, 5) if schedule else 0.1
    tlr = cosine_schedule(0.1, 2, 5) if schedule else 0.1
    for _ in range(5):
        g = _tree(rng)
        jp, js = jadamw_update(jax.tree_util.tree_map(jnp.asarray, g), js,
                               jp, lr=jlr, weight_decay=0.01)
        tp, ts = adamw_update(tree_map(t, g), ts, tp, lr=tlr,
                              weight_decay=0.01)
        for a, b in zip(jax.tree_util.tree_leaves(jp), tree_leaves(tp)):
            close(b, a, OPT_TOL)
        for a, b in zip(jax.tree_util.tree_leaves((js.mu, js.nu)),
                        tree_leaves((ts.mu, ts.nu))):
            assert b.dtype == getattr(torch, str(a.dtype))
            close(b.float(), np.asarray(a, np.float32), OPT_TOL)
    assert int(ts.count) == int(js.count) == 5


@pytest.mark.parametrize("max_norm", [1.0, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(np.random.default_rng(1))
    jg, jn = jclip(jax.tree_util.tree_map(jnp.asarray, g), max_norm)
    tg, tn = clip_by_global_norm(tree_map(t, g), max_norm)
    close(tn, jn, OPT_TOL)
    for a, b in zip(jax.tree_util.tree_leaves(jg), tree_leaves(tg)):
        close(b, a, OPT_TOL)
    if max_norm == 1.0:  # clipped to the norm
        total = np.sqrt(sum(float((x ** 2).sum()) for x in tree_leaves(tg)))
        assert abs(total - 1.0) < 1e-5


@pytest.mark.parametrize("step", [0, 10, 55, 100])
def test_cosine_schedule_matches_jax(step):
    want = jcosine(1.0, warmup_steps=10, total_steps=100,
                   min_frac=0.1)(jnp.int32(step))
    got = cosine_schedule(1.0, warmup_steps=10, total_steps=100,
                          min_frac=0.1)(torch.tensor(step, dtype=torch.int32))
    close(got, want, OPT_TOL)


# -- the data ---------------------------------------------------------------------
def test_tokenizer_matches_jax():
    s = "paged attention ✓ 分页"
    tok, jtok = ByteTokenizer(), JTokenizer()
    for bos, eos in ((True, False), (False, True)):
        assert tok.encode(s, bos, eos) == jtok.encode(s, bos, eos)
    assert tok.decode(tok.encode(s)) == s == jtok.decode(jtok.encode(s))
    assert (tok.BOS, tok.EOS, tok.PAD, tok.vocab_size) == (
        jtok.BOS, jtok.EOS, jtok.PAD, jtok.vocab_size)


def _same_batches(ours, theirs, n=3):
    for _ in range(n):
        a, b = next(ours), next(theirs)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("name", [None, "llama-3.2-vision-11b",
                                  "whisper-medium"])
def test_synthetic_batches_match_jax(name):
    """The same arrays for the same seed, the vlm/encdec extras too."""
    jcfg = get_smoke(name) if name else None
    tcfg = tget_smoke(name) if name else None
    _same_batches(synthetic_batches(3, 17, 512, seed=4, cfg=tcfg),
                  jsynthetic(3, 17, 512, seed=4, cfg=jcfg))


@pytest.mark.parametrize("n_ids", [500, 7])  # long, and tiled up
def test_lm_batches_and_text_to_ids_match_jax(tmp_path, n_ids):
    path = tmp_path / "text.txt"
    path.write_text("the paged kv cache ✓ " * (n_ids // 20 + 1))
    ids, jids = text_to_ids(str(path)), jtext_to_ids(str(path))
    np.testing.assert_array_equal(ids, jids)
    ids = ids[:n_ids]
    _same_batches(lm_batches(ids, 2, 16, seed=5, cfg=tget_smoke(
                      "whisper-medium")),
                  jlm_batches(ids, 2, 16, seed=5, cfg=get_smoke(
                      "whisper-medium")))


# -- checkpoints --------------------------------------------------------------------
def _state(name="olmoe-1b-7b"):
    cfg = tget_smoke(name)
    gen = torch.Generator().manual_seed(0)
    return TrainState.create(build_model(cfg).init_params(gen, device="cpu"))


def test_checkpoint_roundtrip(tmp_path):
    state = _state()
    state = state._replace(step=state.step + 3)
    save(str(tmp_path / "ck.npz"), state)
    target = tree_map(torch.zeros_like, state)
    back = restore(str(tmp_path / "ck.npz"), target)
    assert type(back) is TrainState
    for a, b in zip(tree_leaves(state), tree_leaves(back)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_checkpoint_missing_key_and_wrong_shape_raise(tmp_path):
    params = _state("granite-8b").params
    save(str(tmp_path / "p.npz"), params)
    with pytest.raises(KeyError, match="missing"):
        restore(str(tmp_path / "p.npz"), dict(params, extra=torch.zeros(2)))
    bad = tree_map(lambda p: torch.zeros((1,) + tuple(p.shape)), params)
    with pytest.raises(ValueError, match="shape"):
        restore(str(tmp_path / "p.npz"), bad)


def test_checkpoint_files_cross_between_packages(tmp_path):
    """Flat slash-joined keys: a port ``TrainState`` file restores into a
    JAX ``TrainState`` of the same tree, and the other way round."""
    p0 = _tree(np.random.default_rng(2))
    tstate = TrainState.create(tree_map(t, p0))
    tstate = tstate._replace(step=tstate.step + 7)
    save(str(tmp_path / "port.npz"), tstate)
    jtarget = JTrainState.create(jax.tree_util.tree_map(jnp.zeros_like, p0))
    jback = jrestore(str(tmp_path / "port.npz"), jtarget)
    assert int(jback.step) == 7
    np.testing.assert_array_equal(np.asarray(jback.params["b"]["y"]),
                                  p0["b"]["y"])
    jsave(str(tmp_path / "jax.npz"), jback)
    back = restore(str(tmp_path / "jax.npz"), tree_map(torch.zeros_like,
                                                       tstate))
    for a, b in zip(tree_leaves(tstate), tree_leaves(back)):
        assert torch.equal(a, b)


# -- a JAX train state carried across ---------------------------------------------
def test_jax_train_state_continues_in_port():
    """Two JAX steps, then the third step in both packages from the same
    state and batch: equal loss and grad norm."""
    name = "granite-moe-1b-a400m"
    jcfg, tcfg = get_smoke(name), tget_smoke(name)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jstate = JTrainState.create(jm.init_params(jax.random.PRNGKey(0)))
    jstep = jax.jit(jmake_train_step(jm, lr=2e-3))
    batches = jsynthetic(2, 16, jcfg.vocab_size, seed=0, cfg=jcfg)
    for _ in range(2):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v)
                                   for k, v in next(batches).items()})
    batch = next(batches)
    _, jm3 = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    tstate = train_state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    assert int(tstate.step) == 2 and int(tstate.opt.count) == 2
    tstate3, tm3 = make_train_step(tm, lr=2e-3)(tstate,
                                                to_device(batch, "cpu"))
    assert int(tstate3.step) == 3
    for k in ("loss", "grad_norm", "ce", "aux"):
        want, got = float(jm3[k]), float(tm3[k])
        assert abs(got - want) <= STEP_TOL * abs(want), (k, got, want)


# -- the loop and the launcher --------------------------------------------------------
def test_loss_decreases_on_learnable_data():
    cfg = tget_smoke("granite-8b")
    data = synthetic_batches(4, 32, cfg.vocab_size, seed=0, cfg=cfg)
    _, hist = train_loop(build_model(cfg), data, steps=40, lr=2e-3,
                         log_every=10, log_fn=lambda s: None, device="cpu")
    assert [h["step"] for h in hist] == [10, 20, 30, 40]
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1


def test_moe_aux_loss_is_finite_and_learns():
    cfg = tget_smoke("granite-moe-1b-a400m")
    data = synthetic_batches(4, 32, cfg.vocab_size, seed=0, cfg=cfg)
    _, hist = train_loop(build_model(cfg), data, steps=30, lr=2e-3,
                         log_every=10, log_fn=lambda s: None, device="cpu",
                         impl="chunked")
    assert np.isfinite(hist[-1]["aux"]) and hist[-1]["aux"] > 0
    assert hist[-1]["loss"] < hist[0]["loss"]


def test_launcher_smoke_on_cpu(tmp_path, capsys):
    ck = tmp_path / "params.npz"
    state, hist = launch_train.main(
        ["--arch", "llama2-7b", "--smoke", "--steps", "3", "--batch", "2",
         "--seq", "16", "--log-every", "1", "--device", "cpu",
         "--checkpoint", str(ck)])
    out = capsys.readouterr().out
    assert out.count("loss") == 3 and "saved" in out
    assert [h["step"] for h in hist] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in hist)
    back = restore(str(ck), state.params)
    for a, b in zip(tree_leaves(state.params), tree_leaves(back)):
        assert torch.equal(a, b)


def test_launcher_default_lr_is_the_reference_rate():
    """The JAX launcher's step always runs at 3e-4
    (``repro.launch.steps.build_train_step``); the port's ``--lr``
    defaults to it, so a default run trains as the reference does."""
    args = launch_train.parse_args(["--arch", "llama2-7b"])
    assert args.lr == 3e-4


def test_entry_points_default_to_the_card():
    """Each entry point asks for the card unless told otherwise; this host
    has none, so each raises instead of running on the CPU."""
    assert not torch.cuda.is_available()
    cfg = tget_smoke("llama2-7b")
    data = synthetic_batches(2, 8, cfg.vocab_size)
    with pytest.raises(EngineConfigError, match="no CUDA device"):
        train_loop(build_model(cfg), data, steps=1)
    with pytest.raises(EngineConfigError, match="no CUDA device"):
        launch_train.main(["--arch", "llama2-7b", "--smoke", "--steps", "1"])
    p0 = _tree(np.random.default_rng(0))
    jstate = jax.tree_util.tree_map(np.asarray, JTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, p0)))
    with pytest.raises(EngineConfigError, match="no CUDA device"):
        train_state_from_numpy(jstate)
    with pytest.raises(EngineConfigError, match="no CUDA device"):
        params_from_numpy(p0)


def test_train_impl_is_checked():
    """The training path takes "chunked"; serving does not, and each
    error names what its entry point takes."""
    cfg = tget_smoke("llama2-7b")
    model = build_model(cfg)
    with pytest.raises(EngineConfigError, match="'chunked'"):
        make_train_step(model, impl="jnp")
    params = _state("llama2-7b").params
    state = {"pos": torch.zeros(1, dtype=torch.int32),
             "tables": torch.zeros((1, 1, 1), dtype=torch.int32),
             "k_pages": torch.zeros((2, 1, 8, cfg.n_kv_heads, 64)),
             "v_pages": torch.zeros((2, 1, 8, cfg.n_kv_heads, 64))}
    with pytest.raises(EngineConfigError, match=r"\('kernel', 'ref'\)"):
        model.prefill(params, torch.zeros((1, 4), dtype=torch.long), state,
                      impl="chunked")
