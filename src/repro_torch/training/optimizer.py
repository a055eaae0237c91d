"""AdamW + cosine schedule + global-norm clipping, as plain tensor ops
(port of ``repro.training.optimizer``).

On the port's parameter tree: the optimizer state is a tree ``(mu, nu)``
of the parameters' structure plus a step ``count``.  ``adamw_update``
returns new trees; ``adamw_update_`` writes the same numbers into the
params' and moments' own storage, leaf by leaf (the port's counterpart
of the JAX step's donated state: the state is not held twice).  The
arithmetic is the JAX package's, in its order and with its casts: f32
math, the moments stored in their tree's dtype, the learning rate taken
at the incremented count, the global norm returned before clipping.  Not ``torch.optim.AdamW``: it rounds in
another order and keeps its state per parameter object, so a JAX train
state (``models.convert.train_state_from_numpy``) or a checkpoint could
not carry across.  Everything runs under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


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
                        cut_axes: Optional[Sequence[Tuple[str, ...]]] = None):
    """(grads scaled by ``min(1, max_norm / norm)``, the global norm
    before clipping); the squares summed leaf by leaf in f32.

    ``cut_axes`` (per leaf, in ``tree_leaves`` order): the mesh axes of
    the active mesh over which the leaf holds only this rank's piece
    ("model" and/or the FSDP axes; () for a whole leaf).  The squares of
    the leaves cut over the same axes are summed over those axes, and
    each leaf counts once, so every rank gets the norm of the whole
    tree."""
    leaves = tree_leaves(grads)
    sq = [torch.sum(torch.square(g.float())) for g in leaves]
    if cut_axes is not None and any(cut_axes):
        from repro_torch.distributed.collectives import all_reduce
        parts = {}
        for s, axes in zip(sq, cut_axes):
            parts[tuple(axes)] = parts.get(tuple(axes), 0) + s
        gnorm = torch.sqrt(sum(all_reduce(v, axes) if axes else v
                               for axes, v in parts.items()))
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
def adamw_update(grads, state: AdamWState, params, **kw
                 ) -> Tuple[Any, AdamWState]:
    """One AdamW step. Returns (new_params, new_state): ``adamw_update_``
    on copies, the given trees left as they are (``kw``: its ``lr``,
    ``b1``, ``b2``, ``eps``, ``weight_decay``)."""
    new_p = tree_map(torch.clone, params)
    new = AdamWState(mu=tree_map(torch.clone, state.mu),
                     nu=tree_map(torch.clone, state.nu), count=state.count)
    return new_p, adamw_update_(grads, new, new_p, **kw)


@torch.no_grad()
def adamw_update_(
    grads,
    state: AdamWState,
    params,
    *,
    lr,  # float or callable(step) -> lr
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> AdamWState:
    """One AdamW step in place: each leaf's new params and moments
    written into its own storage (``params`` and ``state.mu``/``state.nu``
    may be views of larger tensors), one leaf at a time, so that a step
    holds no second copy of the state.  Returns the state with the same
    trees and the incremented count."""
    count = state.count + 1
    lr_t = (lr(count) if callable(lr)
            else torch.tensor(lr, dtype=torch.float32, device=count.device))
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * torch.square(g32)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) \
            + weight_decay * p.float()
        p.copy_((p - lr_t * step.to(p.dtype)).to(p.dtype))
        # moments are stored in their tree's dtype, as in the JAX package
        m.copy_(m32.to(m.dtype))
        v.copy_(v32.to(v.dtype))
        del g32, m32, v32, step  # before the next leaf's are made
    return AdamWState(mu=state.mu, nu=state.nu, count=count)
