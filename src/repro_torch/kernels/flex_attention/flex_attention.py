"""Block-sparse flash attention with FlexAttention semantics: kernel K4
and its plain version.

K4 (``flex_attention_kernel``, CUDA ``csrc/flex_prefill.cu``) replaces the
TPU kernel ``repro/kernels/flex_attention/flex_attention.py::_flex_kernel``.
One CUDA block per (batch, head, q-tile) visits only the kv tiles its
``BlockMask`` row lists, skips the element mask on ``is_full`` tiles,
maps GQA heads by ``h // G`` and normalises in the kernel.  It has two
routes, chosen by ``flex_route`` from the dtype alone, both on the tensor
cores with K/V by TMA: bf16 on the bf16 tile (``flex_fwd_kernel_tc``,
wgmma), f32 on the split-TF32 tile (``flex_fwd_kernel_tf32``: every
product as three TF32 products, which keeps the f32 tolerance).  Each
route counts its own launches in ``flex_attention_kernel.launches_by_route``.

Mask and score mods built from ``core.flex`` are lowered (``lower_mods``)
into one compiled descriptor that both routes evaluate in the kernel: the
mask in disjunctive normal form, an ``or`` of up to ``MAX_TERMS`` terms,
each the ``and`` of a per-row column range ``[lo, hi)`` — causal, window,
prefix-LM, padding and full are all such ranges — and of element
predicates (``document_mask``, ``paged_mask``; up to ``MAX_PREDS``
distinct ones); the score mod as up to ``MAX_STEPS`` softcap and ALiBi
steps, applied to the scaled score before the mask, as in the Pallas body.
A mask of one term without predicates (the engine's causal ∧ padding and
window ∧ padding) runs on the per-row column limits alone; anything else
evaluates the terms per element on the tiles that are not full.  Each
descriptor family counts its launches in
``flex_attention_kernel.launches_by_variant`` ("tc/window&padding", ...).
A mod that is not built from ``core.flex`` (a Python function the kernel
cannot trace) raises ``UnsupportedFeature`` on both devices.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import flex
from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.kernels import (check_head_dim, dry_tally, tensor_core_p,
                                  tf32_product, use_kernel)
from repro_torch.kernels.build import check, get_lib

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)
MAX_Q_BLOCK = 128
ROUTES = ("tc", "tf32x3")

# the descriptor's limits and codes (csrc/flex_prefill.cu: kMaxTerms, ...)
MAX_TERMS, MAX_PREDS, MAX_STEPS = 8, 4, 4
PRED_DOCUMENT, PRED_PAGED = 1, 2
STEP_SOFTCAP, STEP_ALIBI = 1, 2
KIND_ELEMENT, KIND_SCORE = 1, 2  # compiled kinds: bit flags
_INT_MAX = 2 ** 31 - 1
_MAX_WINDOW = 2 ** 30


def flex_route(dtype: torch.dtype) -> str:
    """K4's route for inputs of ``dtype``: "tc", the bf16 tensor-core
    kernel, for bf16; "tf32x3", the split-TF32 tensor-core kernel, for
    f32 (one TF32 product keeps about three digits, too few for the f32
    contract; three, hi·hi + hi·lo + lo·hi, keep about 21 bits)."""
    return "tc" if dtype == torch.bfloat16 else "tf32x3"


@dataclass(frozen=True, eq=False)
class Term:
    """One ``and`` term of a lowered mask: keys in ``[lo, hi)`` with
    lo = q - window + 1 (no bound for None), hi = min(max(q + 1, prefix)
    (no bound for None; 0 is causal), lens[b] of every padding tensor),
    and every element predicate (the ``AuxMod``s of ``preds``)."""
    window: Optional[int] = None
    prefix: Optional[int] = None
    plens: Tuple[torch.Tensor, ...] = ()
    preds: Tuple[flex.AuxMod, ...] = ()

    def __and__(self, other: "Term") -> "Term":
        def low(a, b):
            return b if a is None else a if b is None else min(a, b)
        preds = self.preds + tuple(p for p in other.preds
                                   if all(p is not x for x in self.preds))
        return Term(low(self.window, other.window),
                    low(self.prefix, other.prefix),
                    self.plens + other.plens, preds)

    @property
    def name(self) -> str:
        parts = []
        if self.window is not None:
            parts.append("window")
        elif self.prefix is not None:
            parts.append("causal" if self.prefix <= 0 else "prefix_lm")
        if self.plens:
            parts.append("padding")
        parts += ["document" if p.fn is flex._document_fn else "paged"
                  for p in self.preds]
        return "&".join(parts) or "full"


@dataclass(frozen=True, eq=False)
class Lowered:
    """A mask and score mod as K4 compiles them: the mask as an ``or`` of
    ``terms``, the score mod as ``steps`` ((STEP_SOFTCAP, cap) or
    (STEP_ALIBI, slopes)), applied in order."""
    terms: Tuple[Term, ...]
    steps: Tuple[tuple, ...] = ()

    @property
    def preds(self) -> List[flex.AuxMod]:
        out: List[flex.AuxMod] = []
        for t in self.terms:
            out += [p for p in t.preds if all(p is not x for x in out)]
        return out

    @property
    def kind(self) -> int:
        """The compiled kind: KIND_ELEMENT unless the mask is one term of
        column ranges alone, KIND_SCORE when there is a score mod."""
        element = len(self.terms) != 1 or bool(self.terms[0].preds)
        return (KIND_ELEMENT if element else 0) | (
            KIND_SCORE if self.steps else 0)

    @property
    def name(self) -> str:
        mask = "|".join(t.name for t in self.terms) or "none"
        return mask + "".join(
            "+softcap" if k == STEP_SOFTCAP else "+alibi"
            for k, _ in self.steps)


def _mask_terms(mod) -> Optional[Tuple[Term, ...]]:
    """The mask mod in disjunctive normal form, or None when it is not
    built from ``core.flex``."""
    if mod is flex.full_mask:
        return (Term(),)
    if mod is flex.causal_mask:
        return (Term(prefix=0),)
    if isinstance(mod, functools.partial) and not mod.args:
        if mod.func is flex._window_fn:
            w = mod.keywords["window"]
            return (Term(window=w, prefix=0),) if w > 0 else ()
        if mod.func is flex._prefix_lm_fn:
            return (Term(prefix=mod.keywords["prefix_len"]),)
        return None
    if isinstance(mod, flex.AuxMod) and not mod.is_score:
        if mod.fn is flex._padding_fn:
            return (Term(plens=mod.aux),)
        if mod.fn in (flex._document_fn, flex._paged_fn):
            return (Term(preds=(mod,)),)
    kind = getattr(mod, "combine", None)
    if kind not in ("and", "or"):
        return None
    terms: Optional[Tuple[Term, ...]] = None
    for part in mod.parts:
        sub = _mask_terms(part)
        if sub is None:
            return None
        if terms is None:
            terms = sub
        elif kind == "or":
            terms = terms + sub
        else:
            terms = tuple(a & b for a in terms for b in sub)
    return terms


def _score_steps(mod) -> Optional[Tuple[tuple, ...]]:
    """The score mod as softcap / ALiBi steps, or None when it is not
    built from ``core.flex``."""
    if mod is None or mod is flex.identity_score:
        return ()
    if (isinstance(mod, functools.partial) and not mod.args
            and mod.func is flex._softcap_fn):
        return ((STEP_SOFTCAP, mod.keywords["cap"]),)
    if isinstance(mod, flex.AuxMod) and mod.fn is flex._alibi_fn:
        return ((STEP_ALIBI, mod.aux[0]),)
    if getattr(mod, "combine", None) != "compose":
        return None
    steps: Tuple[tuple, ...] = ()
    for part in mod.parts:
        sub = _score_steps(part)
        if sub is None:
            return None
        steps += sub
    return steps


def lower_mods(mask_mod, score_mod=None) -> Lowered:
    """Lower a mask mod and a score mod built from ``core.flex`` into K4's
    descriptor; raise ``UnsupportedFeature`` for anything else (a Python
    function the kernel cannot trace) or past the descriptor's limits.
    Runs on both devices, so that the CPU sees what the card refuses."""
    terms = _mask_terms(mask_mod)
    if terms is None:
        raise UnsupportedFeature("flex kernel: the mask mod is not built "
                                 "from core.flex mods (a Python mod cannot "
                                 "be compiled into the CUDA kernel)")
    steps = _score_steps(score_mod)
    if steps is None:
        raise UnsupportedFeature("flex kernel: the score mod is not built "
                                 "from core.flex mods (a Python mod cannot "
                                 "be compiled into the CUDA kernel)")
    low = Lowered(terms, steps)
    if (len(terms) > MAX_TERMS or len(low.preds) > MAX_PREDS
            or len(steps) > MAX_STEPS):
        raise UnsupportedFeature(
            f"flex kernel: {len(terms)} or-terms, {len(low.preds)} element "
            f"predicates, {len(steps)} score steps (the descriptor holds "
            f"{MAX_TERMS}, {MAX_PREDS}, {MAX_STEPS})")
    return low


def _descriptor(low: Lowered, B: int, device) -> Tuple[ctypes.Array, list]:
    """The descriptor's words for the C entry (int64: counts, then per
    term window, prefix, padding-bound pointer and predicate bits, per
    predicate kind, three pointers and their lengths, per step kind, value
    and length), and the device tensors it points into (kept alive until
    the launch)."""
    keep: list = []

    def dev(x, dtype):
        x = torch.as_tensor(x).to(device=device, dtype=dtype).contiguous()
        keep.append(x)
        return x

    preds = low.preds
    words = [len(low.terms), len(preds), len(low.steps)]
    for t in low.terms:
        plen = 0
        if t.plens:
            bound = None
            for lens in t.plens:
                if tuple(lens.shape) != (B,):
                    raise EngineConfigError("flex kernel: padding lens "
                                            "must be (B,)")
                x = dev(lens, torch.int32)
                bound = x if bound is None else torch.minimum(bound, x)
            plen = dev(bound, torch.int32).data_ptr()
        bits = sum(1 << i for i, p in enumerate(preds)
                   if any(p is x for x in t.preds))
        window = 0 if t.window is None else min(t.window, _MAX_WINDOW)
        prefix = (_INT_MAX if t.prefix is None
                  else max(0, min(t.prefix, _INT_MAX)))
        words += [window, prefix, plen, bits]
    for p in preds:
        if p.fn is flex._document_fn:
            docs = dev(p.aux[0], torch.int32)
            if docs.dim() != 2:
                raise EngineConfigError("flex kernel: document ids must be "
                                        "(B, S)")
            words += [PRED_DOCUMENT, docs.data_ptr(), 0, 0,
                      docs.shape[1], docs.shape[0], 0]
        else:
            sid, pos, lens = (dev(x, torch.int32).reshape(-1)
                              for x in p.aux)
            words += [PRED_PAGED, sid.data_ptr(), pos.data_ptr(),
                      lens.data_ptr(), sid.numel(), pos.numel(),
                      lens.numel()]
    for kind, value in low.steps:
        if kind == STEP_SOFTCAP:
            bits = struct.unpack("<i", struct.pack("<f", value))[0]
            words += [kind, bits, 0]
        else:
            slopes = dev(value, torch.float32).reshape(-1)
            words += [kind, slopes.data_ptr(), slopes.numel()]
    return (ctypes.c_int64 * len(words))(*words), keep


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
                          kv_len, score_mod=None, p_terms=None,
                          tf32_terms=None):
    """Plain version of K4: the same tile selection, score mod, masks and
    softmax, evaluated densely one batch row at a time, score mod then
    mask as in the Pallas body.  The mods see indices clamped into
    (q_len, kv_len), so that mods reading tensors stay in bounds on the
    padded tiles (whose scores the validity mask drops).  ``p_terms`` = 1
    rounds the probabilities to bf16 before p.V, as the bf16 tensor-core
    kernel does (None keeps them f32; the sum stays f32 either way).
    ``tf32_terms`` (3 or 1) evaluates q.K and p.V as the split-TF32 kernel
    does (`tf32_product`; the scale applies after q.K there)."""
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
    qc = qi.clamp(max=max(q_len - 1, 0))[None]
    kc = ki.clamp(max=max(kv_len - 1, 0))[None]
    neg = torch.tensor(NEG_INF, device=dev)
    out = torch.empty_like(q)
    for b in range(B):
        bt = torch.tensor(b, device=dev)
        lt = listed[b] if block_mask.batched else listed
        ft = full[b] if block_mask.batched else full
        lt = lt.repeat_interleave(qb, 0).repeat_interleave(kb, 1)
        ft = ft.repeat_interleave(qb, 0).repeat_interleave(kb, 1)
        mask = (ft | mask_mod(bt, hi, qc, kc)) & lt & valid  # (H|1, Q, K)
        kh = k[b].float().repeat_interleave(G, dim=0)  # (H, K, D)
        vh = v[b].float().repeat_interleave(G, dim=0)
        if tf32_terms:
            s = tf32_product(torch.matmul, q[b].float(), kh.transpose(1, 2),
                             tf32_terms) * scale
        else:
            s = torch.matmul(q[b].float() * scale, kh.transpose(1, 2))
        if score_mod is not None:
            s = score_mod(s, bt, hi, qc, kc)
        s = torch.where(mask, s, neg)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(mask, torch.exp(s - m),
                        torch.tensor(0.0, device=dev))
        l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
        pv = (tf32_product(torch.matmul, p, vh, tf32_terms) if tf32_terms
              else torch.matmul(tensor_core_p(p, p_terms), vh))
        out[b] = (pv / l).to(q.dtype)
    return out


def mask_pairs(low: Lowered, q_len: int, kv_len: int) -> int:
    """Upper bound of the live (query, key) pairs of one batch row and
    head under the lowered mask: a term's column range ``[lo, hi)`` per
    query row (causal, window, prefix-LM), padding and element predicates
    taken as all live (they depend on the data); a mask of several terms
    at ``q_len · kv_len``."""
    if len(low.terms) != 1:
        return q_len * kv_len
    t = low.terms[0]
    q = np.arange(q_len)
    hi = (np.full(q_len, kv_len) if t.prefix is None
          else np.minimum(np.maximum(q + 1, t.prefix), kv_len))
    lo = np.maximum(q - t.window + 1, 0) if t.window is not None else 0
    return int(np.maximum(hi - lo, 0).sum())


def flex_cost(q_shape, kv_shape, item: int, pairs: int):
    """K4's (operations, bytes): 4·D operations per live (query, key)
    pair and head, ``pairs`` summed over the batch rows; q, k and v (of
    ``q_shape`` (B, H, Q, D) and ``kv_shape`` (B, Hkv, K, D)) read once and
    the output written once, ``item`` bytes per element."""
    B, H, Q, D = q_shape
    kv = math.prod(kv_shape)
    return 4 * D * H * pairs, (2 * B * H * Q * D + 2 * kv) * item


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
    low = lower_mods(mask_mod, score_mod)
    if not use_kernel("flex_attention", q, k, v, block_mask.kv_indices):
        return _flex_attention_plain(q, k, v, block_mask, scale=scale,
                                     mask_mod=mask_mod, score_mod=score_mod,
                                     q_len=q_len, kv_len=kv_len)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise UnsupportedFeature(f"flex kernel: dtypes q {q.dtype} k "
                                 f"{k.dtype} v {v.dtype}")
    check_head_dim("flex kernel", D)
    if q_blk > MAX_Q_BLOCK or H % Hkv:
        raise UnsupportedFeature(f"flex kernel: q tile {q_blk} (max "
                                 f"{MAX_Q_BLOCK}), heads {H}/{Hkv}")
    if (k.shape != (B, Hkv, K, D) or v.shape != k.shape
            or not all(t.is_contiguous() for t in (q, k, v))):
        raise EngineConfigError("flex kernel: q (B,H,Q,D) and k, v "
                                "(B,Hkv,K,D) must be contiguous")
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
    route = flex_route(q.dtype)
    o = torch.empty_like(q)
    tally = dry_tally(q)
    if tally is not None:  # dry mode: K4 stands in (``kernels``)
        tally.add(("flex_prefill", f"flex_prefill/{route}",
                   f"flex_prefill/{route}/{low.name}"),
                  *flex_cost(q.shape, k.shape, q.element_size(),
                             B * mask_pairs(low, q_len, kv_len)))
        return o
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise EngineConfigError("flex kernel: q, k and v must be 16-byte "
                                "aligned")
    desc, keep = _descriptor(low, B, q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            nb.data_ptr(), idx.data_ptr(), full.data_ptr(), desc, len(desc),
            B, H, Hkv, Q, K, D, nq, max_kv, int(batched), q_blk, kv_blk,
            int(q_len), int(kv_len), float(scale))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        name = "flex_attention_fwd_" + ("tc" if route == "tc" else "tf32")
        err = getattr(get_lib(), name)(low.kind, *args, stream)
    check(err, name)
    del keep  # the kernel is enqueued; the stream orders any reuse
    flex_attention_kernel.launches += 1
    flex_attention_kernel.launches_by_route[route] += 1
    variants = flex_attention_kernel.launches_by_variant
    key = f"{route}/{low.name}"
    variants[key] = variants.get(key, 0) + 1
    return o


flex_attention_kernel.launches = 0
flex_attention_kernel.launches_by_route = dict.fromkeys(ROUTES, 0)
flex_attention_kernel.launches_by_variant = {}
