"""AdamW + cosine schedule + global-norm clipping, as plain tensor ops
(port of ``repro.training.optimizer``).

Functional, on the port's parameter tree: the optimizer state is a tree
``(mu, nu)`` of the parameters' structure plus a step ``count``, and an
update returns new trees.  The arithmetic is the JAX package's, in its
order and with its casts: f32 math, the moments stored in their tree's
dtype, the learning rate taken at the incremented count, the global
norm returned before clipping.  Not ``torch.optim.AdamW``: it rounds in
another order and keeps its state per parameter object, so a JAX train
state (``models.convert.train_state_from_numpy``) or a checkpoint could
not carry across.  Everything runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    mu: Any  # first moment, same tree as params
    nu: Any  # second moment
    count: torch.Tensor  # () int32 step counter


def _device(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def adamw_init(params) -> AdamWState:
    return AdamWState(mu=tree_map(torch.zeros_like, params),
                      nu=tree_map(torch.zeros_like, params),
                      count=torch.zeros((), dtype=torch.int32,
                                        device=_device(params)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float,
                        sharded: Optional[Sequence[bool]] = None):
    """(grads scaled by ``min(1, max_norm / norm)``, the global norm
    before clipping); the squares summed leaf by leaf in f32.

    ``sharded`` (one flag per leaf, in ``tree_leaves`` order): the leaves
    that hold only this rank's piece over the active mesh's "model" axis.
    Their squares are summed over "model", and each replicated leaf
    counts once, so every rank gets the norm of the whole tree."""
    leaves = tree_leaves(grads)
    sq = [torch.sum(torch.square(g.float())) for g in leaves]
    if sharded is not None and any(sharded):
        from repro_torch.distributed.collectives import all_reduce
        part = all_reduce(sum(s for s, c in zip(sq, sharded) if c),
                          ("model",))
        gnorm = torch.sqrt(part + sum(s for s, c in zip(sq, sharded)
                                      if not c))
    else:
        gnorm = torch.sqrt(sum(sq))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), gnorm


def cosine_schedule(base_lr: float, warmup_steps: int, total_steps: int,
                    min_frac: float = 0.1) -> Callable:
    """Linear warmup then cosine decay to ``min_frac * base_lr``."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


@torch.no_grad()
def adamw_update(
    grads,
    state: AdamWState,
    params,
    *,
    lr,  # float or callable(step) -> lr
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    """One AdamW step. Returns (new_params, new_state)."""
    count = state.count + 1
    lr_t = (lr(count) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=count.device))
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(g, m, v, p):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        mhat = m32 / c1
        vhat = v32 / c2
        step = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p.float()
        # moments are stored in their tree's dtype, as in the JAX package
        return ((p - lr_t * step.to(p.dtype)).to(p.dtype),
                m32.to(m.dtype), v32.to(v.dtype))

    out = [upd(*leaves) for leaves in zip(
        tree_leaves(grads), tree_leaves(state.mu), tree_leaves(state.nu),
        tree_leaves(params))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(mu=new_m, nu=new_v, count=count)
