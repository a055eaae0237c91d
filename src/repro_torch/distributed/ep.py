"""Expert-parallel MoE dispatch over ``all_to_all_single`` (port of
``repro.distributed.ep``).

Each rank holds ``E / m`` experts of the "model" axis and its own batch
rows:

    route the rank's tokens → capacity C_l = T_l·k/E·cf → dispatch
    buffer (E, C_l, d); all_to_all over "model": (E, C_l, d) →
    (E/m, m·C_l, d); the local experts' FFN; all_to_all back →
    (E, C_l, d); the local weighted combine.

Capacity is per rank (``T_l`` its live tokens), as in the JAX function,
so with a finite factor the drops may differ from the single-device
``apply_moe`` over the whole batch; dropless (capacity 0) both are exact.
The load-balance loss is the JAX function's too: each data shard's
local loss, averaged over the batch axes' ranks — not the whole batch's
loss that ``models.moe.apply_moe_train(batch_axes=)`` computes without
EP (the two differ when a batch axis holds more than one rank).
As in ``models.moe``, only ``live`` tokens are routed (the port's rule:
padding takes no expert slot and counts in no capacity).  The expert
products are batched matmuls, as the JAX ``einsum``s run outside any
Pallas kernel.

Under autograd (training under ``moe_ep``) the gradients are
``jax.grad``'s through the JAX ``shard_map``.  The activations are whole
over "model", so the m ranks of a data shard route the same tokens and
each expert's owner receives m copies of every token it serves, one
from each rank, and sends each copy's output back to it.  Every rank
computes the whole loss, so each copy's cotangent is the whole
gradient: the exchanges' backward (``collectives.exchange``: the
all-to-all of the cotangent) would give each expert m times its
gradient.  JAX's transpose divides the replicated output's cotangent by
m and sums the replicated inputs' cotangents (``x``, ``router``) over
"model"; here each rank's ``x`` and ``router`` already get the whole
gradient (the copy of the tokens a rank sent comes back only to it), so
only the expert weights' gradients are divided by m (``_ScaleGrad``):
the same numbers, with no collective for ``x`` or the router.

Under sequence parallelism (``TPLayout.seq``) a rank holds only its
slice of the sequence, and a rank that kept only its slice of the
output would receive only that slice's cotangent: the m ranks'
cotangents would add up to the whole once, and the law above would
give each expert 1/m of its gradient and ``x`` and the router only
their slice's part.  The model (``TransformerModel._moe_ep``) therefore
gathers the sequence before this function (JAX's ``in_specs`` take
``x`` whole over "model") with a backward that keeps the rank's slice
of the gradient, and keeps its slice of the output with a backward
that gathers the slices' cotangents (``collectives.split_dim``): every
rank again holds the whole tokens and the whole cotangent, and the law
above stands unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.collectives import exchange, reduce_sum
from repro_torch.distributed.sharding import current_mesh, current_rules
from repro_torch.models import moe as moe_mod
from repro_torch.utils.fake import count_true

EXPERT_WEIGHTS = ("wg", "wu", "wd")


def _batch_axes(mesh) -> Tuple[str, ...]:
    phys = current_rules().physical("batch") or ()
    return tuple(a for a in phys if a in mesh.axis_names)


class _ScaleGrad(torch.autograd.Function):
    """The identity; its gradient times ``s``."""

    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def apply_moe_ep(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 live: Optional[torch.Tensor] = None,
                 n_live: Optional[int] = None, ws: Tuple[str, ...] = ()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE FFN of this rank's tokens ``x`` (B_l, S, d) or (B_l, d)
    with its ``E / m`` experts (``p["wg"]`` etc. (E/m, ...)); ``router``
    whole.  ``live`` of x's leading shape marks the tokens routed (None:
    every token), ``n_live`` counts them (read on the host when None).
    Returns (the output, of x's shape and dtype; the load-balance loss
    over the live tokens, averaged over the batch axes' ranks).  ``ws``:
    ``x`` holds the rank's columns of ``embed`` (``TPLayout.act_embed``,
    weight-stationary decode): the router's and the experts' up
    products sum their partials over those axes, and the exchanges
    carry the rank's columns."""
    mesh = current_mesh()
    m = mesh.size("model")
    shape = x.shape
    d = shape[-1]
    xf = x.reshape(-1, d)
    T_l = xf.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    if live is not None:
        live = live.reshape(T_l)
        T_l = count_true(live) if n_live is None else n_live
    probs, gates, idx = moe_mod.router(p, xf, k, ws=ws)
    aux = moe_mod.aux_loss(probs, idx, live)
    ba = _batch_axes(mesh)
    if ba:
        aux = reduce_sum(aux, ba) / mesh.prod(ba)
    slot, ok, disp = moe_mod.dispatch(idx, moe_mod.capacity(T_l, cfg), E,
                                      live)
    C = disp.shape[1]
    xe = xf[torch.clamp(disp, max=xf.shape[0] - 1)]  # (E, C, d)
    # experts to their owning rank: (m, E/m, C, d) -> (E/m, m·C, d)
    xe = exchange(xe, ("model",)).reshape(m, E // m, C, d)
    xe = xe.transpose(0, 1).reshape(E // m, m * C, d)
    w = {n: _ScaleGrad.apply(p[n], 1.0 / m) for n in EXPERT_WEIGHTS}
    ye = moe_mod.expert_ffn(w, xe, cfg, ws)
    # back to the tokens' rank: (E/m, m, C, d) -> (m, E/m, C, d) -> (E, C, d)
    ye = ye.reshape(E // m, m, C, d).transpose(0, 1).contiguous()
    ye = exchange(ye, ("model",)).reshape(E, C, d)
    out = moe_mod.combine(ye, gates, idx, slot, ok)
    return out.to(x.dtype).reshape(shape), aux
