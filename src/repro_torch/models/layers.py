"""Shared building blocks (port of ``repro.models.layers``)."""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec
from repro_torch.utils.fake import on_card


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def norm_spec(cfg: ModelConfig) -> Dict:
    if cfg.norm == "layernorm":
        return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones"),
                "bias": ParamSpec((cfg.d_model,), ("embed",), "zeros")}
    return {"scale": ParamSpec((cfg.d_model,), ("embed",), "ones")}


def apply_norm(p: Dict, x: torch.Tensor, eps: float = 1e-6,
               axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """RMSNorm (or LayerNorm with a bias), computed in f32.  ``axes``
    (``TPLayout.act_embed``): ``x`` holds the rank's columns of the
    features, cut over those mesh axes, and ``p`` the matching slices;
    the f32 sums (the mean first, then the squares about it, for
    LayerNorm) are all-reduced over them before the rsqrt."""
    xf = x.float()
    if axes:
        from repro_torch.distributed.collectives import all_reduce
        from repro_torch.distributed.sharding import current_mesh
        d = x.shape[-1] * current_mesh().prod(axes)

        def mean(t):
            return all_reduce(t.sum(dim=-1, keepdim=True), axes) / d
    else:
        def mean(t):
            return t.mean(dim=-1, keepdim=True)
    if "bias" in p:
        mu = mean(xf)
        var = (mean((xf - mu).square()) if axes
               else xf.var(dim=-1, keepdim=True, unbiased=False))
        y = (xf - mu) * torch.rsqrt(var + eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    ms = mean(xf.square())
    return (xf * torch.rsqrt(ms + eps) * p["scale"]).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary / sinusoidal positions
# ---------------------------------------------------------------------------
def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation: x (..., H, D), positions (...,)."""
    if theta <= 0:
        return x
    D = x.shape[-1]
    half = D // 2
    exponent = torch.arange(half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * freqs  # (..., half)
    sin = torch.sin(ang)[..., None, :]  # broadcast over heads
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=16)
def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """The (n, d) sinusoidal table, computed in f64 with numpy and then
    cast to f32, as in the JAX package (whisper's monolithic prefill and
    encoder).  Built once per (n, d, device) and shared: read-only."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * dim / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.tensor(out, dtype=torch.float32, device=device)


def sinusoidal_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal embedding at positions (...,) → (..., d) in the f32
    closed form (no table: decode positions are unbounded).  It differs
    from ``sinusoidal_positions`` by the f32 rounding of the angles, as
    the JAX package's two functions do."""
    dim = torch.arange(d // 2, dtype=torch.float32, device=positions.device)
    # the f32 exponent; the power correctly rounded to f32, as XLA's (an
    # f32 pow differs from it in the last bit, which the largest
    # positions multiply by 1e3)
    inv = torch.pow(10000.0, (-2.0 * dim / d).double()).float()
    ang = positions[..., None].float() * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------
# the activations of the ported configs: SwiGLU (llama, granite), GeGLU
# (recurrentgemma), squared ReLU (nemotron) and ungated GELU (whisper)
ACTIVATIONS = ("silu", "gelu", "relu2", "gelu_ungated")


def mlp_spec(cfg: ModelConfig) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.activation in ("silu", "gelu"):  # gated (SwiGLU / GeGLU)
        return {"wg": ParamSpec((d, f), ("embed", "mlp")),
                "wu": ParamSpec((d, f), ("embed", "mlp")),
                "wd": ParamSpec((f, d), ("mlp", "embed"))}
    return {"wu": ParamSpec((d, f), ("embed", "mlp")),
            "wd": ParamSpec((f, d), ("mlp", "embed"))}


def reduce_model(y: torch.Tensor, dtype=None, seq: bool = False
                 ) -> torch.Tensor:
    """Sum partial sums over the mesh's "model" axis in f32 (Megatron's
    all-reduce after ``wo`` and ``wd``, and the vocab-sharded lookup);
    the result in ``dtype`` (default: ``y``'s).  Under autograd the
    gradient passes through (``collectives.reduce_sum``).  ``seq``
    (sequence parallelism, ``TPLayout.seq``): ``y`` is (B, S, ...) and
    the rank keeps its slice of the sum along S, reduce-scattered
    (``collectives.scatter_dim``: under autograd the gradient of the
    slice comes back whole)."""
    from repro_torch.distributed.collectives import reduce_sum, scatter_dim
    if seq:
        return scatter_dim(y.float(), ("model",), 1).to(dtype or y.dtype)
    return reduce_sum(y.float(), ("model",)).to(dtype or y.dtype)


def copy_model(x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient summed over "model" under autograd
    (``collectives.copy_in``): the input of a column-parallel product."""
    from repro_torch.distributed.collectives import copy_in
    return copy_in(x, ("model",))


def seq_gather(x: torch.Tensor, summed: bool = True) -> torch.Tensor:
    """The whole sequence (B, S, ...) of the rank's slice ``x`` (B, S/m,
    ...) over "model" (sequence parallelism, ``TPLayout.seq``).  Under
    autograd, ``summed``: the gradient of the whole is summed over the
    ranks and cut to the slice (Megatron-SP's all-gather before a
    column-parallel product, whose every rank computes its own part);
    else the rank's slice of it (every rank computed the same whole)."""
    from repro_torch.distributed.collectives import gather_dim
    return gather_dim(x, ("model",), 1, summed)


def seq_split(x: torch.Tensor) -> torch.Tensor:
    """The rank's slice along the sequence (dim 1) of ``x``, which every
    rank over "model" computed whole; under autograd the gradient comes
    back whole on every rank (``collectives.split_dim``)."""
    from repro_torch.distributed.collectives import split_dim
    return split_dim(x, ("model",), 1)


def gather_fsdp(p, spec_tree, layout, batch_axes: Tuple[str, ...] = ()):
    """The whole weights of ``p``, a tree of this rank's pieces cut over
    ``layout.fsdp`` (``TPLayout``; ``spec_tree`` its ``ParamSpec`` tree),
    gathered leaf by leaf along each one's cut dim
    (``collectives.gather_dim``) just before they are used; every other
    cut (over "model") stays.  Under autograd each gradient comes back as
    the rank's piece, summed over the FSDP axes where they carry
    different rows (``batch_axes``; FSDP's reduce-scatter).  ``p`` as it
    is without FSDP."""
    if not layout.fsdp:
        return p
    from repro_torch.distributed.collectives import gather_dim
    from repro_torch.distributed.sharding import current_mesh, fsdp_dims
    summed = set(layout.fsdp) <= set(batch_axes)

    def walk(x, d):
        if isinstance(x, dict):
            return {k: walk(v, d[k]) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, e) for v, e in zip(x, d)]
        return x if d is None else gather_dim(x, layout.fsdp, d, summed)

    return walk(p, fsdp_dims(spec_tree, layout, current_mesh()))


def _partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 (``w`` 2-D, or 3-D batched against a 3-D ``x``),
    a partial sum that is still to be reduced: 2-D bf16 inputs on the
    card take cuBLAS's f32 accumulator as it is (``mm``'s
    ``out_dtype``), so the only rounding to bf16 is the one a single
    device makes after the sum (not under autograd, which ``out_dtype``
    does not take; the dry run's fake tensors trace the card's branch).
    A batched product rounds in ``x``'s dtype first:
    ``FlopCounterMode`` refuses ``bmm``'s ``out_dtype``."""
    if w.dim() == 2 and x.dtype == torch.bfloat16 and on_card(x) and not (
            torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)):
        return torch.mm(x.reshape(-1, x.shape[-1]), w,
                        out_dtype=torch.float32).reshape(
                            *x.shape[:-1], w.shape[-1])
    return (x @ w).float()


def row_parallel_matmul(x: torch.Tensor, w: torch.Tensor,
                        seq: bool = False) -> torch.Tensor:
    """``x @ w`` for a ``w`` that holds this rank's rows of the contraction
    (row-parallel), summed over "model" (under ``seq`` reduce-scattered
    along the sequence, ``reduce_model``), in ``x``'s dtype; the rank's
    partial product stays in f32 until the sum (``_partial``)."""
    return reduce_model(_partial(x, w), x.dtype, seq)


def ws_contract(x: torch.Tensor, ws, axes: Tuple[str, ...]) -> list:
    """``[x @ w for w in ws]`` under weight-stationary decode
    (``TPLayout.act_embed``): ``x`` holds the rank's columns of
    ``embed`` (cut over the mesh ``axes``) and each ``w`` the matching
    rows of the contraction (2-D, or 3-D batched against a 3-D ``x``:
    the experts); the f32 partials (``_partial``) are all-reduced over
    ``axes`` in one call, packed along the last dim, before anything
    nonlinear sees them, and each product comes back in ``x``'s dtype
    with the shape of the whole product."""
    from repro_torch.distributed.collectives import all_reduce
    parts = [_partial(x, w) for w in ws]
    sums = all_reduce(torch.cat(parts, dim=-1), axes)
    return [t.to(x.dtype) for t in torch.split(
        sums, [t.shape[-1] for t in parts], dim=-1)]


def ws_pieces(p, spec_tree, layout):
    """The rank's slice of the ``embed`` dim of every weight of ``p``
    (a tree of this rank's pieces, ``spec_tree`` its ``ParamSpec``
    tree) under weight-stationary decode (``TPLayout.act_embed``): a
    piece that FSDP cut over the same axes (``layout.fsdp``) as it is,
    a whole one as a view of its slice ``flat_index(act_embed)``; no
    copy and no collective.  FSDP over other axes than the activations'
    raises ``UnsupportedFeature`` (its pieces are not the rank's
    columns, and nothing here gathers them)."""
    from repro_torch.distributed.sharding import current_mesh, fsdp_dims
    from repro_torch.errors import UnsupportedFeature
    from repro_torch.models.spec import ParamSpec
    axes = layout.act_embed
    if layout.fsdp and tuple(layout.fsdp) != tuple(axes):
        raise UnsupportedFeature(
            f"weight-stationary decode with FSDP over {layout.fsdp} and "
            f"the activations over {axes}", fsdp=layout.fsdp,
            act_embed=axes)
    mesh = current_mesh()
    n, r = mesh.prod(axes), mesh.flat_index(axes)

    def walk(x, spec, cut):
        if isinstance(spec, dict):
            return {k: walk(x[k], spec[k], cut[k]) for k in x}
        if isinstance(spec, list):
            return [walk(v, s, c) for v, s, c in zip(x, spec, cut)]
        assert isinstance(spec, ParamSpec)
        if cut is not None or "embed" not in spec.axes:
            return x
        d = spec.axes.index("embed")
        w = x.shape[d] // n
        return x.narrow(d, r * w, w)

    return walk(p, spec_tree, fsdp_dims(spec_tree, layout, mesh))


def _activate(up, cfg: ModelConfig) -> torch.Tensor:
    """The MLP's hidden activations from its up products: ``[x @ wg, x @
    wu]`` when gated, ``[x @ wu]`` otherwise."""
    if cfg.activation == "silu":
        return F.silu(up[0]) * up[1]
    if cfg.activation == "gelu":  # jax.nn.gelu's default: the tanh form
        return F.gelu(up[0], approximate="tanh") * up[1]
    if cfg.activation == "gelu_ungated":  # the tanh form, as above
        return F.gelu(up[0], approximate="tanh")
    return torch.square(F.relu(up[0]))  # relu2, checked when built


def apply_mlp(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              row_parallel: bool = False, seq: bool = False,
              ws: Tuple[str, ...] = ()) -> torch.Tensor:
    """The dense MLP.  ``row_parallel``: ``wg``/``wu`` hold this rank's
    column slice of ``d_ff`` and ``wd`` the matching rows (Megatron,
    ``TPLayout.mlp``), and the partial sums are reduced over "model" in
    f32 (``row_parallel_matmul``); under autograd the gradient of ``x``
    is summed over "model" (``copy_model``).  ``seq``: ``x`` is the
    rank's slice of the sequence (``TPLayout.seq``), gathered whole
    first; the output is the rank's slice, reduce-scattered from the
    partial sums (row-parallel) or cut from the whole (``seq_split``).
    ``ws`` (``TPLayout.act_embed``): ``x`` and the output are the rank's
    columns of ``embed`` and ``p`` its slices (``ws_pieces``): ``wg``/
    ``wu``'s partials summed over those axes (``ws_contract``), ``wd``
    giving the rank's columns."""
    if ws:
        up = ws_contract(x, [p[k] for k in ("wg", "wu") if k in p], ws)
        h = _activate(up, cfg)
        return row_parallel_matmul(h, p["wd"]) if row_parallel else (
            h @ p["wd"])
    if seq:
        x = seq_gather(x, summed=row_parallel)
        if not row_parallel:
            return seq_split(apply_mlp(p, x, cfg))
    elif row_parallel:
        x = copy_model(x)
    h = _activate([x @ p[k] for k in ("wg", "wu") if k in p], cfg)
    if row_parallel:
        return row_parallel_matmul(h, p["wd"], seq)
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def embed_spec(cfg: ModelConfig) -> Dict:
    out = {"tok": ParamSpec((cfg.vocab_size, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"))
    return out


def embed_tokens(p: Dict, tokens: torch.Tensor,
                 vocab_sharded: bool = False, seq: bool = False
                 ) -> torch.Tensor:
    """The tokens' rows of ``p["tok"]``.  ``vocab_sharded``: the table is
    this rank's slice of the vocab over the active mesh's "model" axis
    (``TPLayout.vocab``): rows outside it read zeros, and the sum over the
    axis gives every token its row.  ``seq``: the rank keeps its slice of
    the sequence (``TPLayout.seq``): the sum reduce-scattered along it,
    or with the vocab whole its slice of the rows (``seq_split``).  A
    table of the rank's columns of ``embed`` (``ws_pieces``) gives those
    columns of the rows."""
    tok = p["tok"]
    if not vocab_sharded:
        x = tok[tokens.long()]
        return seq_split(x) if seq else x
    from repro_torch.distributed.sharding import axis_index
    local = tokens.long() - axis_index("model") * tok.shape[0]
    mine = (local >= 0) & (local < tok.shape[0])
    x = tok[torch.where(mine, local, 0)] * mine[..., None].to(tok.dtype)
    return reduce_model(x, seq=seq)


def unembed(p: Dict, x: torch.Tensor, cfg: ModelConfig,
            vocab_sharded: bool = False, seq: bool = False,
            ws: Tuple[str, ...] = ()) -> torch.Tensor:
    """Logits (..., V).  ``vocab_sharded``: the table is this rank's
    vocab slice (``TPLayout.vocab``), and its logits are gathered over
    "model" along the vocab (``collectives.gather_last``: under autograd
    the rank's columns of the gradient come back, and ``x``'s gradient is
    summed over "model").  ``seq``: ``x`` (B, S/m, d) is the rank's slice
    of the sequence, gathered whole first (every token's logits on every
    rank).  ``ws`` (``TPLayout.act_embed``): ``x`` holds the rank's
    columns of ``embed`` and the table its slice (``ws_pieces``): the
    partial logits are summed over those axes (``ws_contract``) before
    the vocab gather and the softcap."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    if seq:
        x = seq_gather(x, summed=vocab_sharded)
    if ws:
        logits = ws_contract(x, [w], ws)[0]
    elif vocab_sharded:
        logits = (x if seq else copy_model(x)) @ w
    else:
        logits = x @ w
    if vocab_sharded:
        from repro_torch.distributed.collectives import gather_last
        logits = gather_last(logits, ("model",))
    if cfg.logit_softcap > 0:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def xent(logits: torch.Tensor, targets: torch.Tensor,
         mask: Optional[torch.Tensor] = None,
         batch_axes: Tuple[str, ...] = ()) -> torch.Tensor:
    """Mean next-token cross entropy in f32 over (B, S, V) logits and
    (B, S) targets; with a (B, S) ``mask`` the mean over its weight (at
    least 1).  ``batch_axes``: the rows are this rank's share of a batch
    over those mesh axes, and the result is this rank's part of the
    global mean — its sum over the weight (or token count) of every
    rank's rows — so that the parts add up over the ranks."""
    from repro_torch.distributed.collectives import all_reduce, spans
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if spans(batch_axes):
        w = (torch.ones_like(nll) if mask is None else mask.float())
        count = all_reduce(w.sum().detach(), batch_axes)
        return torch.sum(nll * w) / torch.clamp(count, min=1.0)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
