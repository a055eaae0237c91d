"""Block-sparse flash attention with FlexAttention semantics: kernel K4
and its plain version.

K4 (``flex_attention_kernel``, CUDA ``csrc/flex_prefill.cu``) replaces the
TPU kernel ``repro/kernels/flex_attention/flex_attention.py::_flex_kernel``.
One CUDA block per (batch, head, q-tile) visits only the kv tiles its
``BlockMask`` row lists, skips the element mask on ``is_full`` tiles,
maps GQA heads by ``h // G`` and normalises in the kernel.

Mask mods are compiled variants of the kernel, for the mods the prefill
path composes: ``full_mask``, ``causal_mask``, ``padding_mask(lens)`` and
``and_masks`` of those.  Any other mask mod, and any score mod, raises
``UnsupportedFeature`` on both devices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import flex
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.kernels import use_kernel
from repro_torch.kernels.build import check, get_lib

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
FLEX_HEAD_DIMS = (64, 128)
MAX_Q_BLOCK = 128

# compiled mask variants: bit 0 = causal, bit 1 = padding(lens)
FULL, CAUSAL, PADDING = 0, 1, 2


def mask_variant(mask_mod) -> Optional[Tuple[int, Optional[torch.Tensor]]]:
    """Map a mask mod onto ``(variant bits, padding lens)``, or None when
    it is not a composition of the kernel's compiled mods."""
    if mask_mod is flex.full_mask:
        return FULL, None
    if mask_mod is flex.causal_mask:
        return CAUSAL, None
    if isinstance(mask_mod, flex.AuxMod) and mask_mod.fn is flex._padding_fn:
        return PADDING, mask_mod.aux[0]
    parts = getattr(mask_mod, "parts", ())
    if not parts:
        return None
    bits, lens = FULL, None
    for part in parts:
        sub = mask_variant(part)
        if sub is None or (sub[1] is not None and lens is not None):
            return None
        bits |= sub[0]
        lens = sub[1] if sub[1] is not None else lens
    return bits, lens


def _tile_maps(block_mask: flex.BlockMask, nk: int):
    """(listed, full) tile maps ``([B,] nq, nk)`` from a BlockMask."""
    idx = block_mask.kv_indices.long()
    j = torch.arange(idx.shape[-1], device=idx.device)
    live = j < block_mask.kv_num_blocks[..., None]
    shape = idx.shape[:-1] + (nk,)
    listed = torch.zeros(shape, dtype=torch.int32, device=idx.device)
    listed.scatter_add_(-1, idx, live.to(torch.int32))
    full = torch.zeros(shape, dtype=torch.int32, device=idx.device)
    full.scatter_add_(-1, idx, (live & block_mask.is_full.bool()
                                ).to(torch.int32))
    return listed > 0, full > 0


def _flex_attention_plain(q, k, v, block_mask, *, scale, mask_mod, q_len,
                          kv_len):
    """Plain version of K4: the same tile selection, masks and softmax,
    evaluated densely one batch row at a time."""
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    G = H // Hkv
    qb, kb = block_mask.q_block, block_mask.kv_block
    listed, full = _tile_maps(block_mask, K // kb)
    dev = q.device
    qi = torch.arange(Q, device=dev)[:, None]
    ki = torch.arange(K, device=dev)[None, :]
    hi = torch.arange(H, device=dev)[:, None, None]
    valid = (qi < q_len) & (ki < kv_len)
    neg = torch.tensor(NEG_INF, device=dev)
    out = torch.empty_like(q)
    for b in range(B):
        lt = listed[b] if block_mask.batched else listed
        ft = full[b] if block_mask.batched else full
        lt = lt.repeat_interleave(qb, 0).repeat_interleave(kb, 1)
        ft = ft.repeat_interleave(qb, 0).repeat_interleave(kb, 1)
        elem = mask_mod(torch.tensor(b, device=dev), hi, qi[None], ki[None])
        mask = (ft | elem) & lt & valid  # (H or 1, Q, K)
        kh = k[b].float().repeat_interleave(G, dim=0)  # (H, K, D)
        vh = v[b].float().repeat_interleave(G, dim=0)
        s = torch.matmul(q[b].float() * scale, kh.transpose(1, 2))
        s = torch.where(mask, s, neg)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m),
                        torch.tensor(0.0, device=dev))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        out[b] = (torch.matmul(p, vh) / l).to(q.dtype)
    return out


def flex_attention_kernel(
    q: torch.Tensor,  # (B, H, Q, D)
    k: torch.Tensor,  # (B, Hkv, K, D)
    v: torch.Tensor,
    block_mask: flex.BlockMask,
    *,
    scale: float,
    mask_mod=flex.causal_mask,
    score_mod=None,
    q_len: int = 0,  # true (pre-padding) lengths; 0 = no padding
    kv_len: int = 0,
) -> torch.Tensor:
    """K4: returns (B, H, Q, D) in q's dtype.  Q and K must be multiples
    of the block mask's tiles (the op pads)."""
    B, H, Q, D = q.shape
    Hkv, K = k.shape[1], k.shape[2]
    q_len = q_len or Q
    kv_len = kv_len or K
    q_blk, kv_blk = block_mask.q_block, block_mask.kv_block
    if Q % q_blk or K % kv_blk:
        raise EngineConfigError("flex kernel: Q and K must be padded to "
                                "the block mask's tiles", Q=Q, K=K)
    if score_mod is not None:
        raise UnsupportedFeature("flex kernel: score mods are not compiled "
                                 "into the CUDA kernel yet")
    variant = mask_variant(mask_mod)
    if variant is None:
        raise UnsupportedFeature("flex kernel: mask mod is not a "
                                 "composition of full/causal/padding")
    if not use_kernel("flex_attention", q, k, v, block_mask.kv_indices):
        return _flex_attention_plain(q, k, v, block_mask, scale=scale,
                                     mask_mod=mask_mod, q_len=q_len,
                                     kv_len=kv_len)
    bits, lens = variant
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise UnsupportedFeature(f"flex kernel: dtypes q {q.dtype} k "
                                 f"{k.dtype} v {v.dtype}")
    if D not in FLEX_HEAD_DIMS or q_blk > MAX_Q_BLOCK or H % Hkv:
        raise UnsupportedFeature(f"flex kernel: head_dim {D} (takes "
                                 f"{FLEX_HEAD_DIMS}), q tile {q_blk} (max "
                                 f"{MAX_Q_BLOCK}), heads {H}/{Hkv}")
    if (k.shape != (B, Hkv, K, D) or v.shape != k.shape
            or not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                       for t in (q, k, v))):
        raise EngineConfigError("flex kernel: q (B,H,Q,D) and k, v "
                                "(B,Hkv,K,D) must be contiguous and "
                                "16-byte aligned")
    nq = Q // q_blk
    batched = block_mask.batched
    lead = (B, nq) if batched else (nq,)
    nb = block_mask.kv_num_blocks.to(torch.int32).contiguous()
    idx = block_mask.kv_indices.to(torch.int32).contiguous()
    full = block_mask.is_full.to(torch.int32).contiguous()
    max_kv = idx.shape[-1]
    if (tuple(nb.shape) != lead or tuple(idx.shape) != lead + (max_kv,)
            or full.shape != idx.shape):
        raise EngineConfigError("flex kernel: block mask shapes do not "
                                "match the q tiles", q_tiles=nq)
    if lens is not None:
        lens = lens.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(lens.shape) != (B,):
            raise EngineConfigError("flex kernel: padding lens must be (B,)")
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = get_lib().flex_attention_fwd(
            _DTYPE_CODES[q.dtype], bits, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), nb.data_ptr(), idx.data_ptr(),
            full.data_ptr(), lens.data_ptr() if lens is not None else None,
            B, H, Hkv, Q, K, D, nq, max_kv, int(batched), q_blk, kv_blk,
            int(q_len), int(kv_len), float(scale),
            torch.cuda.current_stream().cuda_stream)
    check(err, "flex_attention_fwd")
    flex_attention_kernel.launches += 1
    return o


flex_attention_kernel.launches = 0
