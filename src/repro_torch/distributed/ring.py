"""Ring attention (context parallelism) for prefill and training (port of
``repro.distributed.ring``).

Each rank holds one slice of the sequence — its q, k and v with every
head — and the K/V slices travel around the "model" axis (``ring_shift``,
``batch_isend_irecv``) while an online-softmax accumulator folds in one
chunk per step.  The masks use absolute positions (the rank's q offset
and the chunk's kv offset), so causal, sliding-window and right-padded
``lens`` batches all work; fully masked chunks still run (a static
schedule, as in the JAX package).  The JAX ring runs no Pallas kernel;
the chunk partial here is plain torch ops likewise.

Under autograd the ring is differentiable as it stands: the chunk
partials and the merge are plain ops, and the shift is ``ring_pass``,
whose backward sends each chunk's cotangent back to the rank it came
from.  A chunk with no live key for a query (rank 0's queries against
every later chunk under the causal mask; a slice that ``lens`` pads out
whole) holds m = -inf: every exponent of such a row goes through a
``where`` that selects 0 without differentiating the other branch's
``exp(-inf)``, and the output divides by ``l`` only where it is
positive (``l`` is 0 or at least 1), so those rows give finite zero
gradients.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.collectives import ring_pass
from repro_torch.distributed.sharding import current_mesh, current_rules
from repro_torch.errors import EngineConfigError


def _chunk_partial(q, k, v, q_off, k_off, *, scale, causal, window,
                   lens=None, kv_chunk=1024, softcap=0.0):
    """Online-softmax partials of q (B, Hkv, G, Sq, D) against one K/V
    chunk (B, Hkv, Sk, D) at absolute offsets ``q_off``/``k_off``, in
    tiles of ``kv_chunk`` keys.  Returns (m, l, acc) f32; m is -inf where
    no key is live.  q is scaled before the product, in its dtype, as
    ``core.attention``'s chunked path scales it: the same scores, and
    under autograd the same graph, as one device's tiles."""
    B, Hkv, G, Sq, D = q.shape
    Sk = k.shape[2]
    dev = q.device
    kc = min(kv_chunk, Sk)
    nk = -(-Sk // kc)
    q_idx = (q_off + torch.arange(Sq, device=dev))[None, None, None, :, None]
    qf = (q * scale).to(q.dtype).float()
    m = torch.full((B, Hkv, G, Sq), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, Sq), device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), device=dev)
    for j in range(nk):
        kb = k[:, :, None, j * kc:(j + 1) * kc].float()
        vb = v[:, :, None, j * kc:(j + 1) * kc]
        w = kb.shape[3]
        k_idx = (k_off + j * kc + torch.arange(w, device=dev))[
            None, None, None, None, :]
        s = qf @ kb.transpose(-1, -2)  # (B, Hkv, G, Sq, w)
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        live = torch.ones_like(s, dtype=torch.bool)
        if causal:
            live = live & (k_idx <= q_idx)
        if window > 0:
            live = live & (q_idx - k_idx < window)
        if lens is not None:
            live = live & (k_idx < lens.long()[:, None, None, None, None])
        s = s.masked_fill(~live, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(live, torch.exp(s - m_safe[..., None]), 0.0)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + p.to(vb.dtype).float() @ vb.float()
        m = m_new
    return m, l, acc


def _ring_local(q, k, v, lens, *, axis, scale, causal, window, softcap):
    """This rank's part: q/k/v (B, S_l, H|Hkv, D), sequence-local, of the
    rank at index r of ``axis``, whose q starts at ``r·S_l``.  Step i
    holds the chunk of rank (r − i) mod n."""
    mesh = current_mesh()
    n, r = mesh.size(axis), mesh.index(axis)
    B, S_l, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S_l, Hkv, G, D).permute(0, 2, 3, 1, 4)
    q_off = r * S_l
    dev = q.device
    m = torch.full((B, Hkv, G, S_l), float("-inf"), device=dev)
    l = torch.zeros((B, Hkv, G, S_l), device=dev)
    acc = torch.zeros((B, Hkv, G, S_l, D), device=dev)
    kc, vc = k, v
    for i in range(n):
        src = (r - i) % n
        mc, lc, accc = _chunk_partial(
            qg, kc.transpose(1, 2), vc.transpose(1, 2), q_off, src * S_l,
            scale=scale, causal=causal, window=window, lens=lens,
            softcap=softcap)
        m_new = torch.maximum(m, mc)
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        a1 = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        a2 = torch.where(torch.isfinite(mc), torch.exp(mc - m_safe), 0.0)
        l = l * a1 + lc * a2
        acc = acc * a1[..., None] + accc * a2[..., None]
        m = m_new
        if i + 1 < n:  # the JAX scan's last rotation is never read
            kc = ring_pass(kc, (axis,))
            vc = ring_pass(vc, (axis,))
    # l is 0 (no live key: the output 0, as the JAX max(l, 1e-30) gives
    # it) or at least 1; dividing by 1 there keeps the gradient finite
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    # (B, Hkv, G, S_l, D) -> (B, S_l, H, D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S_l, H, D).to(q.dtype)


def ring_ranks() -> int:
    """The ranks a ring over the active mesh's "model" axis spans (1 with
    no mesh or no such axis).  Over more than one, the rules must map
    ``seq`` to ("model",), as the ring plan does: otherwise the tensors
    are not sequence slices, and ``EngineConfigError`` is raised."""
    mesh = current_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return 1
    m = mesh.size("model")
    if m > 1 and current_rules().physical("seq") != ("model",):
        raise EngineConfigError(
            f"ring attention over {m} ranks needs the rule seq -> "
            f"('model',); the active rules map seq to "
            f"{current_rules().physical('seq')}", ranks=m)
    return m


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   lens: Optional[torch.Tensor] = None, causal: bool = True,
                   window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """q: (B, S_l, H, D), k/v: (B, S_l, Hkv, D): this rank's sequence slice
    (slice ``r`` of the "model" axis) of its batch rows; ``lens`` (B,)
    global lengths.  Returns this rank's (B, S_l, H, D) output.  Needs an
    active mesh with a "model" axis (``ring_ranks``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    return _ring_local(q, k, v, lens, axis="model", scale=scale,
                       causal=causal, window=window, softcap=softcap)
