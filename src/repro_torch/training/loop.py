"""Training loop: the step factory and the host-side loop (port of
``repro.training.loop``, one device, no mesh).

``make_train_step`` builds ``step(state, batch) -> (state', metrics)``:
the loss and its gradients by autograd, global-norm clipping, then AdamW
— the JAX package's step, with ``torch.autograd.grad`` in place of
``jax.value_and_grad``.  The attention runs the dense plain path
(``impl="ref"``, JAX's ``"jnp"``) or the chunked online softmax
(``"chunked"``); the flex kernel K4 has no backward, so ``"kernel"``
raises ``UnsupportedFeature`` here.  ``state_shardings`` gives the specs
of the train state ``shard_params`` cuts under a rule table; the steps
across ranks are ``launch.steps.build_train_step``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.attention import TRAIN_IMPLS
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import AxisRules, P, resolve_specs
from repro_torch.kernels import check_impl
from repro_torch.training.optimizer import (AdamWState, adamw_update,
                                            clip_by_global_norm)
from repro_torch.training.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def make_train_step(
    model,
    *,
    lr=3e-4,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    impl: str = "ref",
) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """Returns ``step(state, batch) -> (state', metrics)``; ``batch`` holds
    tensors on the params' device.  ``metrics``: ``loss``, ``grad_norm``
    (before clipping), ``ce`` and ``aux``, as device scalars (nothing here
    waits for the device)."""
    check_impl(impl, TRAIN_IMPLS, "make_train_step")

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, parts, grads = loss_and_grads(model, state.params, batch, impl)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        new_params, new_opt = adamw_update(
            grads, state.opt, state.params, lr=lr, weight_decay=weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step


def loss_and_grads(model, params, batch: Dict, impl: str,
                   attn_ctx: Optional[Dict] = None):
    """(loss, its parts, the gradients of ``params``) of ``model.loss_fn``
    on ``batch``, detached; ``attn_ctx``: a train plan's, for a model
    whose params are a rank's pieces (``launch.steps``): over "model",
    and FSDP's over "data", whose gradients come back as the rank's
    pieces (the reduce-scatter of the gather, ``layers.gather_fsdp``)."""
    params = tree_map(lambda p: p.detach().requires_grad_(), params)
    kw = {"attn_ctx": attn_ctx} if attn_ctx else {}
    loss, parts = model.loss_fn(params, batch, impl=impl, **kw)
    leaves = tree_leaves(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss does not reach gets a zero gradient, as under
    # jax.value_and_grad
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g
        for p, g in zip(leaves, grads)])
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            grads)


def state_shardings(model, mesh, rules: AxisRules) -> TrainState:
    """The specs of a train state cut by ``rules`` on ``mesh`` (the JAX
    ``state_shardings``; ``distributed.sharding.shard_params`` cuts the
    params to them): each parameter by its logical axes (FSDP's
    ``embed`` over "data" where the rules put it), the moments alike, the
    counters whole."""
    p = resolve_specs(model.param_spec(), rules, mesh)
    return TrainState(params=p, opt=AdamWState(mu=p, nu=p, count=P()),
                      step=P())


def to_device(batch: Dict, device) -> Dict:
    """A batch of numpy arrays (``data``) as tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def train_loop(
    model,
    data: Iterable[Dict],
    *,
    steps: int,
    lr=3e-4,
    weight_decay: float = 0.1,
    max_grad_norm: float = 1.0,
    seed: int = 0,
    state: Optional[TrainState] = None,
    log_every: int = 10,
    log_fn: Callable[[str], None] = print,
    impl: str = "ref",
    device="cuda",
    on_step: Optional[Callable[[int, TrainState, Dict], None]] = None,
    step_fn: Optional[Callable[[TrainState, Dict],
                               Tuple[TrainState, Dict]]] = None,
) -> Tuple[TrainState, list]:
    """Host loop: init, iterate.  Returns (final state, metric log).

    Without ``state`` the params are drawn in f32 on ``device`` (the
    card unless the caller asks for the CPU) from a ``torch.Generator``
    seeded with ``seed``; a given ``state`` trains where it lies.  Each
    batch of ``data`` (numpy arrays) moves to that device.  The metrics
    are read on the host only at the logged steps (every ``log_every``-th
    and the last).  ``on_step(i, state, metrics)``, when given, runs after
    every step (a timer's hook).  ``step_fn``: the step to run (a plan's,
    ``launch.steps.build_train_step``; default ``make_train_step``'s)."""
    if state is None:
        device = resolve_device(device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        state = TrainState.create(model.init_params(gen, torch.float32, device))
    device = state.step.device
    step_fn = step_fn or make_train_step(
        model, lr=lr, weight_decay=weight_decay,
        max_grad_norm=max_grad_norm, impl=impl)
    history = []
    t0 = time.perf_counter()
    it = iter(data)
    for i in range(steps):
        batch = to_device(next(it), device)
        state, metrics = step_fn(state, batch)
        if on_step is not None:
            on_step(i, state, metrics)
        if (i + 1) % log_every == 0 or i == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = int(state.step)
            m["wall_s"] = time.perf_counter() - t0
            history.append(m)
            log_fn(f"step {m['step']:5d}  loss {m['loss']:.4f}  "
                   f"gnorm {m['grad_norm']:.3f}  {m['wall_s']:.1f}s")
    return state, history
