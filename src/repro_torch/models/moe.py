"""Mixture-of-Experts FFN: top-k routing with capacity-bounded gather
dispatch (port of ``repro.models.moe``), used by granite-moe (32 experts,
top-8) and olmoe (64 experts, top-8).

The law is the JAX package's: router logits in the activation dtype, an
f32 softmax, ``top_k`` with the gates renormalised by ``max(Σ, 1e-9)``,
the capacity ``C = max(1, int(T·k/E·factor))`` of the config's
``moe_capacity`` (dropless, ``C = T``, when it is 0), each (token, choice)
ranked within its expert by a cumsum over the ``T·k`` assignments in
token-major order, the ``(E, C)`` dispatch buffer of token ids with
sentinel ``T``, the gated expert MLP and an f32 combine.  The expert
products are batched matmuls (``einsum`` in the JAX package, outside any
Pallas kernel).  The combine gathers each token's ``k`` choices and sums
them over ``k``, so a token's output does not depend on atomics.  The
JAX function's second output, the load-balance loss ``E·Σ me·ce`` over
the top-1 choices, is ``aux_loss``: ``apply_moe_train`` returns it
beside the output, from the same router call, for the training loss;
serving does not use it.

Across ranks (``cut=True``, a plan's ``TPLayout.moe() == "cut"``) the
rank holds E/m experts of the mesh's "model" axis, GSPMD's cut of the
JAX rules' ``experts: ("model",)``: it routes its own tokens with the
whole router (dispatch, capacity and ``live`` as on one device), runs its
experts over their rows of the ``(E, C)`` dispatch buffer, and combines
only the choices whose expert it holds, in f32; the partial sums are
reduced over "model" (``collectives.reduce_sum``, Megatron's g).  Under
autograd each rank's combine gives only its part of the gradient of the
gates and of the tokens its experts read, so both are summed over
"model" in the backward (``collectives.copy_in`` on the probabilities
the gates come from and on the experts' input rows); the load-balance
loss, which every rank computes whole from the same probabilities, is
not (its gradient would count m times).  Serving and training run this
one function.

Under sequence parallelism (``seq``, a plan's ``TPLayout.seq``) ``x``
is the rank's slice of the sequence: it is gathered whole first (every
token routed as one device routes it, the capacity the whole rows'),
the cut's partial sums are reduce-scattered back to the slice
(``layers.reduce_model(seq=True)``, whose backward gathers the whole
cotangent) and a whole output is cut to it (``layers.seq_split``,
likewise).  So every rank again computes on the whole tokens with the
whole cotangent, and the gradient law above holds as it is; the
gather's backward takes the rank's slice of the (equal) gradients.

``live`` (a bool per token) is the port's addition: a token that is not
live (prefill padding, a chunk's dead tail, a dead decode slot) takes no
rank in any expert, does not count in ``T`` for the capacity, and gets a
zero output.  With every token live the result is the JAX function's.
Its count ``n_live`` is a host int (the engine knows it), so nothing here
reads the device on the host.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_index, axis_size
from repro_torch.models.layers import (copy_model, reduce_model, seq_gather,
                                       seq_split, ws_contract)
from repro_torch.models.spec import ParamSpec
from repro_torch.utils.fake import count_true


def moe_spec(cfg: ModelConfig) -> Dict:
    d, E, f = cfg.d_model, cfg.n_experts, cfg.expert_ff
    return {
        "router": ParamSpec((d, E), ("embed", None)),
        "wg": ParamSpec((E, d, f), ("experts", "embed", None)),
        "wu": ParamSpec((E, d, f), ("experts", "embed", None)),
        "wd": ParamSpec((E, f, d), ("experts", None, "embed")),
    }


def top_k_route(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gates (T, k) f32, renormalised; experts (T, k)) from the router's
    f32 probabilities.  A stable descending sort breaks ties toward the
    lower expert index, as ``jax.lax.top_k`` does."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    return vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9), idx


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert at the config's ``moe_capacity``: ``n_tokens``
    when it is 0 (dropless)."""
    if not cfg.moe_capacity:
        return n_tokens
    return max(1, int(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.moe_capacity))


def router(p: Dict, x: torch.Tensor, k: int, cut: bool = False,
           ws: Tuple[str, ...] = ()
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of ``x`` (T, d): logits in the activation dtype, an f32
    softmax (T, E), and the top-k gates and experts (T, k).  With
    ``cut`` the gates' gradient is summed over "model" (each rank
    combines only its experts' choices); the probabilities returned, the
    load-balance loss's, are not.  ``ws``: ``x`` holds the rank's
    columns of ``embed`` (``TPLayout.act_embed``), the logits' partials
    summed over those axes before the softmax (``ws_contract``)."""
    logits = (ws_contract(x, [p["router"]], ws)[0] if ws
              else x @ p["router"])
    probs = torch.softmax(logits.float(), dim=-1)
    gates, idx = top_k_route(copy_model(probs) if cut else probs, k)
    return probs, gates, idx


def _expert_range(E: int) -> Tuple[int, int]:
    """(the first expert of this rank, its count): E/m of the active
    mesh's "model" axis (``DistributedSetupError`` without one)."""
    n = E // axis_size("model")
    return axis_index("model") * n, n


def aux_loss(probs: torch.Tensor, idx: torch.Tensor,
             live: Optional[torch.Tensor] = None,
             batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """The load-balance loss (Switch/OLMoE style) of the router's
    ``probs`` (T, E) and experts ``idx`` (T, k): ``E·Σ me·ce``, the mean
    probability times the top-1 share of each expert over the ``live``
    tokens (every token when None).  ``batch_axes``: the tokens are this
    rank's share of a batch over those mesh axes; the loss is not linear
    in the tokens, so each expert's probability sum, top-1 count and the
    token count are summed over the ranks first (the probabilities' sum
    through ``collectives.reduce_sum``: every rank then holds the global
    loss, and its gradient reaches each rank's own tokens)."""
    from repro_torch.distributed.collectives import reduce_sum, spans
    T, E = probs.shape
    top1 = (idx[:, :1] == torch.arange(E, device=probs.device)).float()
    w = (torch.ones(T, device=probs.device) if live is None
         else live.reshape(T).float())
    if spans(batch_axes):
        stats = reduce_sum(torch.cat([(probs * w[:, None]).sum(0),
                                      (top1 * w[:, None]).sum(0),
                                      w.sum()[None]]), batch_axes)
        n = torch.clamp(stats[-1], min=1)
        return E * torch.sum((stats[:E] / n) * (stats[E:2 * E] / n))
    w = w[:, None] / torch.clamp(w.sum(), min=1)
    return E * torch.sum((probs * w).sum(0) * (top1 * w).sum(0))


def dispatch(idx: torch.Tensor, C: int, E: int,
             live: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rank each (token, choice) of ``idx`` (T, k) within its expert by a
    cumsum in token-major order; keep the ranks below ``C``.  Returns
    (slot (T·k,), ok (T·k,), disp (E, C) token ids with sentinel T).  A
    token that is not ``live`` sends its choices to expert E: no rank, not
    kept."""
    T, k = idx.shape
    dev = idx.device
    assign = idx.reshape(-1)  # (T*k,) expert of each (token, choice)
    if live is not None:
        assign = torch.where(live[:, None].expand(T, k).reshape(-1), assign,
                             torch.full_like(assign, E))
    # (E, T*k): the scan runs along the inner dim (a scan along the outer
    # dim of a (T*k, E) one-hot keeps only E threads busy on the card)
    onehot = (torch.arange(E, device=dev)[:, None] == assign).int()
    pos_in_e = torch.cumsum(onehot, 1) - onehot  # rank within expert
    slot = (pos_in_e * onehot).sum(0)  # (T*k,); expert E: no row, 0
    ok = (slot < C) & (assign < E)
    token_of = torch.arange(T, device=dev)[:, None].expand(T, k).reshape(-1)
    # kept (expert, slot) pairs are unique; dropped ones all land on the
    # discarded row E
    disp = torch.full((E + 1, C), T, dtype=torch.long, device=dev)
    disp[torch.where(ok, assign, E), torch.where(ok, slot, 0)] = torch.where(
        ok, token_of, T)
    return slot, ok, disp[:E]


def experts(p: Dict, x: torch.Tensor, disp: torch.Tensor,
            cfg: ModelConfig, ws: Tuple[str, ...] = ()) -> torch.Tensor:
    """The gated expert MLPs over the dispatched rows of ``x`` (T, d):
    (E, C, d).  Empty slots (sentinel T) read an arbitrary row; their
    outputs are never combined."""
    return expert_ffn(p, x[torch.clamp(disp, max=x.shape[0] - 1)], cfg, ws)


def expert_ffn(p: Dict, xe: torch.Tensor, cfg: ModelConfig,
               ws: Tuple[str, ...] = ()) -> torch.Tensor:
    """The gated expert MLPs of the dispatched rows ``xe`` (E, C, d), one
    batched matmul per weight: (E, C, d).  ``ws``: ``xe`` and the output
    hold the rank's columns of ``embed`` (``TPLayout.act_embed``): the
    up products' partials summed over those axes (``ws_contract``),
    ``wd`` giving the rank's columns."""
    if ws:
        g, u = ws_contract(xe, [p["wg"], p["wu"]], ws)
    else:
        g, u = torch.bmm(xe, p["wg"]), torch.bmm(xe, p["wu"])
    if cfg.activation == "silu":
        h = F.silu(g) * u
    else:  # jax.nn.gelu's default: the tanh form
        h = F.gelu(g, approximate="tanh") * u
    return torch.bmm(h, p["wd"])


def combine(ye: torch.Tensor, gates: torch.Tensor, idx: torch.Tensor,
            slot: torch.Tensor, ok: torch.Tensor, lo: int = 0
            ) -> torch.Tensor:
    """Each token's k kept choices of ``ye`` (E, C, d), weighted by their
    gates and summed over k in f32: (T, d) f32.  A gather and a sum, not
    a scatter-add, so a decode step does not depend on atomics.  ``ye``
    holds experts ``lo .. lo + E - 1``; the choices of other experts
    count 0 (a rank's part under the cut)."""
    E, C, d = ye.shape
    T, k = idx.shape
    e = idx - lo
    keep = ok.reshape(T, k) & (e >= 0) & (e < E)
    src = (torch.clamp(e, 0, E - 1) * C
           + torch.where(ok, slot, 0).reshape(T, k))
    c = ye.reshape(E * C, d)[src].float() * gates[..., None]  # (T, k, d)
    return torch.where(keep[..., None], c, 0.0).sum(1)


def _moe(p: Dict, x: torch.Tensor, cfg: ModelConfig,
         live: Optional[torch.Tensor], n: Optional[int], cut: bool = False,
         seq: bool = False, ws: Tuple[str, ...] = ()
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The FFN over the tokens of ``x`` (B, S, d) or (B, d) at the
    capacity of ``n`` live tokens (every token when None): (its f32
    output of x's shape, the router's probabilities and experts).
    ``cut``: ``p`` holds this rank's E/m experts over "model" (GSPMD's
    cut, the module docstring); ``seq``: ``x`` is the rank's slice of
    the sequence, and so is the output (the module docstring); ``ws``:
    ``x`` and the output are the rank's columns of ``embed``
    (``TPLayout.act_embed``: every rank routes the same tokens from the
    summed router logits)."""
    if seq:
        x = seq_gather(x, summed=False)
    shape = x.shape
    xf = x.reshape(-1, shape[-1])
    if n is None:
        n = xf.shape[0]
    probs, gates, idx = router(p, xf, cfg.top_k, cut, ws)
    slot, ok, disp = dispatch(idx, capacity(n, cfg), cfg.n_experts, live)
    if not cut:
        out = combine(experts(p, xf, disp, cfg, ws), gates, idx, slot, ok)
        out = out.reshape(shape)
        return (seq_split(out) if seq else out), probs, idx
    lo, n_e = _expert_range(cfg.n_experts)
    ye = experts(p, copy_model(xf), disp[lo:lo + n_e], cfg, ws)
    out = combine(ye, gates, idx, slot, ok, lo).reshape(shape)
    return reduce_model(out, seq=seq), probs, idx


def apply_moe(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              live: Optional[torch.Tensor] = None,
              n_live: Optional[int] = None, cut: bool = False,
              seq: bool = False, ws: Tuple[str, ...] = ()
              ) -> torch.Tensor:
    """x: (B, S, d) or (B, d); ``live`` of the whole tokens' leading
    shape (or None: every token live), ``n_live`` its count (read from
    ``live`` on the host when None); ``cut``: ``p`` holds this rank's E/m
    experts over "model"; ``seq``: x is the rank's slice (B, S/m, d) of
    the sequence; ``ws``: x holds the rank's columns of ``embed``
    (``TPLayout.act_embed``).  Returns the FFN's output, of x's shape
    and dtype."""
    n = None
    if live is not None:
        live = live.reshape(-1)
        n = count_true(live) if n_live is None else n_live
    out, _, _ = _moe(p, x, cfg, live, n, cut, seq, ws)
    return out.to(x.dtype)


def apply_moe_train(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                    batch_axes: Tuple[str, ...] = (), cut: bool = False,
                    seq: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training FFN, the JAX ``apply_moe``: every token of x (B, S, d)
    routed at the config's capacity.  Returns (the output, of x's shape
    and dtype; ``aux_loss`` over every token), both from one router
    call.  ``batch_axes``: x holds this rank's rows of a batch over those
    mesh axes; the aux loss is the whole batch's, and the capacity is
    this rank's (its tokens' share; dropless, ``moe_capacity=0``, routes
    exactly as one device does).  ``cut``: ``p`` holds this rank's E/m
    experts over "model" (GSPMD's cut); ``seq``: x is the rank's slice
    of the sequence (the whole rows routed)."""
    out, probs, idx = _moe(p, x, cfg, None, None, cut, seq)
    return out.to(x.dtype), aux_loss(probs, idx, batch_axes=batch_axes)
