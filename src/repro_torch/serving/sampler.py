"""Token sampling: greedy / temperature / top-k / top-p, batched
(port of ``repro.serving.sampler``).

Top-p (nucleus) boundary contract, as in the JAX package: the kept set is
the **smallest** prefix of the probability-sorted vocab whose cumulative
mass is ``>= p`` — the token whose cumulative sum *crosses* ``p`` is
included; ``p = 1.0`` disables the filter; tokens tied in logit with the
crossing token are kept too (the cutoff is by value).

Greedy rows take ``argmax`` (first maximal index, as ``jnp.argmax``).
Stochastic rows draw from an explicit ``torch.Generator``; the stream
differs from ``jax.random``'s, so only greedy output matches the JAX
engine token for token.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.errors import InvalidRequest


def validate_sample_params(req) -> None:
    """Reject out-of-domain sampling knobs at ``add_request`` time."""
    t, k, p = req.temperature, req.top_k, req.top_p
    if not math.isfinite(t) or t < 0.0:
        raise InvalidRequest(
            f"temperature must be finite and >= 0, got {t}", rid=req.rid,
            param="temperature", value=t)
    if not (0.0 <= p <= 1.0):  # NaN fails both comparisons
        raise InvalidRequest(
            f"top_p must lie in [0, 1], got {p}", rid=req.rid,
            param="top_p", value=p)
    if k < 0:
        raise InvalidRequest(
            f"top_k must be >= 0 (0 disables), got {k}", rid=req.rid,
            param="top_k", value=k)
    if req.max_new_tokens < 1:
        raise InvalidRequest(
            f"max_new_tokens must be >= 1, got {req.max_new_tokens}",
            rid=req.rid, param="max_new_tokens", value=req.max_new_tokens)


class SampleParams(NamedTuple):
    temperature: torch.Tensor  # (B,) f32; 0 => greedy
    top_k: torch.Tensor  # (B,) int; 0 => off
    top_p: torch.Tensor  # (B,) f32; 1.0 => off


def top_k_mask(lg: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, V) logits → logits below each row's k-th largest at -inf
    (``k <= 0`` disables).  Ties with the k-th value are kept."""
    V = lg.shape[-1]
    srt = torch.sort(lg, dim=-1, descending=True)[0]
    kk = torch.clamp(k.long() - 1, 0, V - 1)[:, None]
    kth = torch.gather(srt, -1, kk)
    drop = (k[:, None] > 0) & (lg < kth)
    return lg.masked_fill(drop, float("-inf"))


def top_p_mask(lg: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(B, V) logits → logits outside each row's nucleus at -inf
    (``p >= 1`` disables).  Inclusive boundary (see module docstring)."""
    srt = torch.sort(lg, dim=-1, descending=True)[0]
    csum = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1)
    # token i kept iff mass strictly before it < p (always keep argmax)
    before = torch.cat([torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)
    keep = before < p[:, None]
    keep[:, 0] = True
    cutoff = torch.where(keep, srt, torch.full_like(srt, float("inf")))
    cutoff = cutoff.amin(dim=-1, keepdim=True)
    drop = (p[:, None] < 1.0) & (lg < cutoff)
    return lg.masked_fill(drop, float("-inf"))


def sample(gen: torch.Generator, logits: torch.Tensor,
           params: SampleParams) -> torch.Tensor:
    """logits: (B, V) -> (B,) int64 tokens."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    if not bool((params.temperature > 0).any()):
        return greedy
    lg = top_p_mask(top_k_mask(logits, params.top_k), params.top_p)
    temp = torch.clamp(params.temperature, min=1e-6)[:, None]
    probs = torch.softmax(lg / temp, dim=-1)
    drawn = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.where(params.temperature <= 0.0, greedy, drawn)
