"""Attention dispatch, one entry point per phase (port of
``repro.core.attention``, single-device paths).

  * ``prefill_attention`` — full-sequence causal attention for training
    and prompt prefill: the flex kernel K4 (``impl="kernel"``, forward
    only), a dense plain path (``impl="ref"``, the JAX ``"jnp"`` path) or
    the online softmax over tiles in plain ops (``impl="chunked"``, the
    JAX ``"chunked"`` path, for training);
  * ``prefill_attention_paged`` — one prompt chunk per sequence against
    the paged KV pools (its K/V already written) through K3 and the
    combine (``impl="kernel"``) or the prefill oracle (``impl="ref"``);
  * ``prefill_attention_windowed_chunk`` — one prompt chunk of a
    sliding-window layer against its intact ring pages and its own fresh
    K/V (attend, then the caller writes), in plain ops as in the JAX
    package;
  * ``decode_attention``  — one token against the paged KV pools through
    K1/K2 (``impl="kernel"``) or the plain oracle (``impl="ref"``);
  * ``decode_attention_contiguous`` — one token against max-length
    contiguous buffers, the paper's baseline, in plain ops as in the JAX
    package (no kernel: the baseline is what the paged kernels beat).

All functions are GQA-aware.  ``impl`` is "kernel" (the default) or
"ref" (``prefill_attention`` also takes "chunked"); anything else raises
``EngineConfigError``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.core import flex
from repro_torch.errors import UnsupportedFeature
from repro_torch.kernels import IMPLS, check_impl
from repro_torch.kernels.flex_attention.ops import flex_attention
from repro_torch.kernels.paged_attention.ops import (choose_decode_params,
                                                     paged_attention,
                                                     paged_prefill)
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention_partials, ring_slot_positions)

# the training entry points (forward, loss_fn, the train step) and
# ``prefill_attention`` also take the chunked online-softmax attention in
# plain ops, and ring attention over the ranks (a ring plan's: with no
# mesh or one rank on "model" it is the chunked path)
TRAIN_IMPLS = IMPLS + ("chunked", "ring")
PREFILL_IMPLS = TRAIN_IMPLS


def prefill_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    lens: Optional[torch.Tensor] = None,
    causal: bool = True,
    impl: str = "kernel",
) -> torch.Tensor:
    """Full-sequence attention for training and prefill.  Returns (B, S,
    H, D).

    ``impl="ring"``: q, k and v are this rank's slice of the sequence
    (slice r of the mesh's "model" axis) and ``lens`` the global lengths:
    ring attention (``distributed.ring``) over a "model" axis of more
    than one rank, which the rules must map ``seq`` to (else
    ``EngineConfigError``: the slices would attend only within
    themselves); with no mesh or one rank on "model" the slice is the
    whole sequence, and the chunked path runs on it.
    ``impl="kernel"`` runs the flex kernel over the mask ``causal ∧
    padding(lens)`` (``window ∧ padding(lens)`` for ``window > 0``, with
    the analytic windowed block mask); ``impl="ref"`` the dense plain
    path; ``impl="chunked"`` the tiled online softmax in plain ops.  The
    kernel has no backward (nor has the JAX package's): under autograd
    with inputs that require grad, ``impl="kernel"`` raises
    ``UnsupportedFeature`` instead of running another path.
    """
    check_impl(impl, PREFILL_IMPLS, "prefill_attention")
    if impl == "ring":
        # context parallelism: q, k, v are this rank's sequence slice, and
        # K/V rotate over the mesh's "model" axis (distributed.ring)
        from repro_torch.distributed.ring import ring_attention, ring_ranks
        if ring_ranks() > 1:
            return ring_attention(q, k, v, lens=lens, causal=causal,
                                  window=window, softcap=softcap)
        impl = "chunked"  # one rank holds the whole sequence
    if impl == "kernel" and torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise UnsupportedFeature(
            "the flex kernel (K4) has no backward: train with impl='ref' "
            "or 'chunked', or run impl='kernel' under torch.no_grad()",
            impl=impl)
    mods = []
    if causal:
        mods.append(flex.sliding_window_mask(window) if window > 0
                    else flex.causal_mask)
    elif window > 0:
        mods.append(flex.sliding_window_mask(window))
    if lens is not None:
        mods.append(flex.padding_mask(lens))
    mask_mod = flex.and_masks(*mods) if mods else flex.full_mask
    score_mod = flex.softcap_score(softcap) if softcap > 0 else None

    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if impl == "kernel":
        out = flex_attention(qt, kt, vt, mask_mod=mask_mod,
                             score_mod=score_mod, window=window)
    elif impl == "chunked":
        out = _chunked_attention(qt, kt, vt, mask_mod, score_mod)
    else:
        out = _dense_attention(qt, kt, vt, mask_mod, score_mod)
    return out.transpose(1, 2)


def _dense_attention(q, k, v, mask_mod, score_mod):
    """(B,H,Q,D)x(B,Hkv,K,D) dense masked attention, f32 scores."""
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, Q, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float())
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev).reshape(Hkv, G)[None, :, :, None, None]
    qi = torch.arange(Q, device=dev)[None, None, None, :, None]
    ki = torch.arange(K, device=dev)[None, None, None, None, :]
    if score_mod is not None:
        s = score_mod(s, bi, hi, qi, ki)
    s = torch.where(mask_mod(bi, hi, qi, ki), s,
                    torch.tensor(-1e30, device=dev))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w.to(v.dtype), v)
    return out.reshape(B, H, Q, D)


def _chunked_attention(q, k, v, mask_mod, score_mod,
                       q_chunk: int = 512, kv_chunk: int = 1024):
    """(B,H,Q,D)x(B,Hkv,K,D) online-softmax attention in (qc × kc) tiles.

    The JAX package's flash in plain ops: an outer loop over q-chunks and
    an inner one over kv-chunks keep live score buffers at
    (B,Hkv,G,qc,kc) whatever the sequence length (under autograd each
    tile's residuals are kept, as JAX's ``scan`` keeps them).  Mask and
    score mods are evaluated per tile on index tensors, so any composed
    mod works unchanged.  Rectangular iteration: no tile is skipped.  A
    query row with no live key gets zeros.
    """
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    G = H // Hkv
    dev = q.device
    qc = min(q_chunk, Q)
    kc = min(kv_chunk, K)
    nq = -(-Q // qc)
    nk = -(-K // kc)
    qpad = torch.nn.functional.pad(q, (0, 0, 0, nq * qc - Q))
    kpad = torch.nn.functional.pad(k, (0, 0, 0, nk * kc - K))
    vpad = torch.nn.functional.pad(v, (0, 0, 0, nk * kc - K))
    qs = (qpad * (1.0 / math.sqrt(D))).to(q.dtype).reshape(
        B, Hkv, G, nq * qc, D).float()
    ks = kpad.float()
    bi = torch.arange(B, device=dev)[:, None, None, None, None]
    hi = torch.arange(H, device=dev).reshape(Hkv, G)[None, :, :, None, None]
    outs = []
    for i in range(nq):
        qb = qs[:, :, :, i * qc:(i + 1) * qc]  # (B, Hkv, G, qc, D)
        q_idx = (i * qc + torch.arange(qc, device=dev))[
            None, None, None, :, None]
        m = torch.full((B, Hkv, G, qc), float("-inf"), device=dev)
        l = torch.zeros((B, Hkv, G, qc), device=dev)
        acc = torch.zeros((B, Hkv, G, qc, D), device=dev)
        for j in range(nk):
            kb = ks[:, :, None, j * kc:(j + 1) * kc]  # (B, Hkv, 1, kc, D)
            vb = vpad[:, :, None, j * kc:(j + 1) * kc]
            k_idx = (j * kc + torch.arange(kc, device=dev))[
                None, None, None, None, :]
            s = qb @ kb.transpose(-1, -2)  # (B, Hkv, G, qc, kc) f32
            if score_mod is not None:
                s = score_mod(s, bi, hi, q_idx, k_idx)
            live = mask_mod(bi, hi, q_idx, k_idx) & (k_idx < K)
            s = s.masked_fill(~live, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(live, torch.exp(s - m_safe[..., None]), 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                0.0)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + p.to(v.dtype).float() @ (
                vb.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(outs, dim=3).reshape(B, H, nq * qc, D)
    return out[:, :, :Q].to(q.dtype)


def prefill_attention_paged(
    q: torch.Tensor,  # (B, C, H, D) — one prompt chunk per sequence
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages)
    kv_lens: torch.Tensor,  # (B,) cached tokens incl. the chunk
    q_start: torch.Tensor,  # (B,) absolute position of chunk token 0
    *,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
) -> torch.Tensor:
    """Chunked paged prefill attention, the prompt-phase counterpart of
    `decode_attention`: the chunk's K/V must already be in the pages
    (write-then-attend), and its queries attend causally over the cached
    prefix and the chunk itself through the block table.  Returns
    (B, C, H, D)."""
    return paged_prefill(q, k_pages, v_pages, block_tables, kv_lens,
                         q_start, softcap=softcap, impl=impl,
                         kv_scale=kv_scale, pages_per_block=pages_per_block,
                         num_splits=num_splits)


def prefill_attention_windowed_chunk(
    q: torch.Tensor,  # (B, C, H, D)
    k_new: torch.Tensor,  # (B, C, Hkv, D) — the chunk's fresh K/V
    v_new: torch.Tensor,
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, D) — ring pools, pre-write
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, ring or more)
    q_start: torch.Tensor,  # (B,) cached prefix length (chunk NOT written)
    q_lens: torch.Tensor,  # (B,) live chunk tokens
    *,
    window: int,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
) -> torch.Tensor:
    """Sliding-window chunked prefill (attend, then the caller writes).

    A ring-paged 'W' layer cannot write first: a long chunk's writes wrap
    the ring and overwrite prefix slots that its earlier queries still
    need.  So the chunk attends over the intact ring prefix (gathered: the
    slots hold the last ``ring·P ≥ window`` prefix positions) plus its own
    fresh K/V.  The JAX package computes this in jnp, outside any Pallas
    kernel, over a working set the ring bounds; these are plain torch ops
    likewise.  Returns (B, C, H, D)."""
    B, C, H, D = q.shape
    num_pages, P, Hkv, _ = k_pages.shape
    G = H // Hkv
    dev = q.device
    scale = 1.0 / math.sqrt(D)

    ring = -(-window // P) + 1
    # mixed dense/windowed models share one table sized for the dense
    # layers: only the first `ring` columns are ring slots here
    block_tables = block_tables[:, :ring]
    S = block_tables.shape[1] * P
    safe = block_tables.clamp(0, num_pages - 1).long()
    kpre = k_pages[safe].reshape(B, S, Hkv, D)
    vpre = v_pages[safe].reshape(B, S, Hkv, D)
    if kv_scale > 0:
        kpre = (kpre.float() * kv_scale).to(q.dtype)
        vpre = (vpre.float() * kv_scale).to(q.dtype)

    # positions the ring slots hold with respect to the prefix (q_start)
    start = q_start.long()
    pre_pos = ring_slot_positions(start, P, ring, S)  # (B, S)
    qpos = start[:, None] + torch.arange(C, device=dev)[None, :]  # (B, C)
    table_live = (block_tables >= 0)[:, :, None].expand(B, -1, P)
    live_pre = ((pre_pos >= 0) & (pre_pos < start[:, None])
                & table_live.reshape(B, S))
    # sliding window: k <= q and q - k < window (flex.sliding_window_mask)
    mask_pre = (live_pre[:, None, :]
                & (qpos[:, :, None] - pre_pos[:, None, :] < window))
    ci = torch.arange(C, device=dev)
    mask_new = ((ci[None, :] <= ci[:, None])
                & (ci[:, None] - ci[None, :] < window))[None]  # (1, C, C)
    mask_new = mask_new & (ci[None, None, :] < q_lens.long()[:, None, None])
    mask = torch.cat([mask_pre, mask_new.expand(B, C, C)], dim=2)

    k_all = torch.cat([kpre, k_new.to(kpre.dtype)], dim=1)
    v_all = torch.cat([vpre, v_new.to(vpre.dtype)], dim=1)
    qg = (q * scale).reshape(B, C, Hkv, G, D)
    s = torch.einsum("bckgd,bskd->bkgcs", qg, k_all.to(q.dtype)).float()
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~mask[:, None, None], float("-inf"))
    w = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    out = torch.einsum("bkgcs,bskd->bckgd", w, v_all.float())
    return out.reshape(B, C, H, D).to(q.dtype)


def decode_attention(
    q: torch.Tensor,  # (B, H, D) — one token per sequence
    k_pages: torch.Tensor,  # (num_pages, P, Hkv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages)
    lens: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    softcap: float = 0.0,
    impl: str = "kernel",
    kv_scale: float = 0.0,
    pages_per_block: Optional[int] = None,
    num_splits: Optional[int] = None,
    kv_axes: Tuple[str, ...] = (),
    page_stride: int = 1,
    page_offset: int = 0,
    combine_mode: Optional[str] = None,
) -> torch.Tensor:
    """Paged decode attention; with ``kv_axes`` flash-decoding over the
    ranks of those mesh axes.

    Without ``kv_axes`` this is the single-device op (the JAX local path):
    ``pages_per_block`` / ``num_splits`` are K1's KV-block width and
    split-K factor (None → auto-tuned, see
    `kernels.paged_attention.ops.choose_decode_params`).

    With ``kv_axes`` the pools and ``block_tables`` hold this rank's page
    stripe: local slot j holds logical page ``j·page_stride +
    page_offset``, and ``lens`` are the rows' global lengths.  Each rank
    computes online-softmax partials over its stripe — K1 on the local
    table with ``collectives.local_lens`` (``impl="kernel"``), or the
    plain ``_partial_decode`` (``impl="ref"``) — and
    ``collectives.merge_flash_partials`` merges them across the ranks
    (``combine_mode``: "kernel" = K2 over every rank's splits, "plain" =
    all-reduce max and sum; None → "kernel" over more than one rank).
    """
    if not kv_axes:
        return paged_attention(q, k_pages, v_pages, block_tables, lens,
                               window=window, softcap=softcap, impl=impl,
                               kv_scale=kv_scale,
                               pages_per_block=pages_per_block,
                               num_splits=num_splits)
    from repro_torch.distributed import collectives
    if window > 0:
        raise UnsupportedFeature("windowed caches are never page-striped "
                                 "(windowed layers decode under dp)")
    check_impl(impl)
    B, H, D = q.shape
    Hkv = k_pages.shape[2]
    scale = 1.0 / math.sqrt(D)
    if impl == "kernel":
        ppb, ns = choose_decode_params(block_tables.shape[1],
                                       k_pages.shape[1], D, pages_per_block,
                                       num_splits)
        m, l, acc = paged_attention_partials(
            q.reshape(B, Hkv, H // Hkv, D).contiguous(), k_pages, v_pages,
            block_tables.contiguous(), collectives.local_lens(
                lens, k_pages.shape[1], page_stride, page_offset),
            scale=scale, softcap=softcap, kv_scale=kv_scale,
            pages_per_block=ppb, num_splits=ns)
    else:
        m, l, acc = _partial_decode(q, k_pages, v_pages, block_tables, lens,
                                    softcap=softcap, page_stride=page_stride,
                                    page_offset=page_offset,
                                    kv_scale=kv_scale)
    out = collectives.merge_flash_partials(m, l, acc, kv_axes,
                                           combine_mode=combine_mode,
                                           out_dtype=q.dtype)
    return out.reshape(B, H, D)


def _partial_decode(q, k_pages, v_pages, block_tables, lens, *, softcap=0.0,
                    page_stride=1, page_offset=0, kv_scale=0.0):
    """Plain online-softmax partials over a rank's page stripe (the JAX
    ``_partial_decode`` on a dense cache): local slot ``s`` is position
    ``(s // P · page_stride + page_offset) · P + s % P``, live below
    ``lens`` (global) and where the table holds a page.  Returns m, l
    (B, Hkv, 1, G) and acc (B, Hkv, 1, G, D), f32, the layout of K1's
    partials with one split; a dead row's m is -1e30."""
    B, H, D = q.shape
    num_pages, P, Hkv, _ = k_pages.shape
    G = H // Hkv
    S = block_tables.shape[1] * P
    safe = block_tables.clamp(0, num_pages - 1).long()
    k = k_pages[safe].reshape(B, S, Hkv, D).float()
    v = v_pages[safe].reshape(B, S, Hkv, D).float()
    if kv_scale > 0:  # int8 pools: dequantised working set
        k, v = k * kv_scale, v * kv_scale
    slot = torch.arange(S, device=q.device)
    pos = (slot // P * page_stride + page_offset) * P + slot % P
    live = pos[None, :] < lens.long()[:, None]
    live &= (block_tables >= 0)[:, :, None].expand(B, -1, P).reshape(B, S)
    qg = (q.float() * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.tensor(
        -1e30, device=q.device))
    p = torch.where(live[:, None, None, :], torch.exp(s - m_safe[..., None]),
                    torch.tensor(0.0, device=q.device))
    acc = torch.einsum("bkgs,bskd->bkgd", p, v)
    return m_safe[:, :, None], p.sum(-1)[:, :, None], acc[:, :, None]


def decode_attention_contiguous(
    q: torch.Tensor,  # (B, H, D)
    k: torch.Tensor,  # (B, Hkv, max_len, D), head-major
    v: torch.Tensor,
    lens: torch.Tensor,  # (B,)
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """The paper's baseline: decode against a max-length contiguous cache.
    Position ``s`` is live when ``s < lens`` (and ``s >= lens - window``
    for ``window > 0``); dead scores are -1e30 before the softmax, so a row
    with no live position averages its buffer, as the JAX function does.
    The buffers are head-major, so both products are strided batched
    matmuls over (B, Hkv) that read K and V in place.  Returns (B, H, D)."""
    B, H, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    G = H // Hkv
    pos = torch.arange(S, device=q.device)[None, :]
    lens = lens.long()[:, None]
    live = pos < lens
    if window > 0:
        live &= pos >= lens - window
    qg = (q * (1.0 / math.sqrt(D))).reshape(B, Hkv, G, D)
    s = torch.matmul(qg, k.to(q.dtype).transpose(-2, -1)).float()
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(live[:, None, None, :], s,
                    torch.tensor(-1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.matmul(w.to(v.dtype), v)
    return out.reshape(B, H, D)
