"""Split-K paged decode attention: kernels K1 and K2 and their plain versions.

K1 (``paged_attention_partials``, CUDA ``csrc/paged_decode.cu``) replaces
the TPU kernel ``repro/kernels/paged_attention/paged_attention.py::
_decode_kernel``: one CUDA block per ``(batch, kv_head, split)`` slot walks
its split's KV pages through the rank-clamped block table and emits the
un-normalised online-softmax partials ``(m, l, acc)``.  K2
(``combine_partials_kernel``, ``csrc/combine.cu``) replaces
``_combine_kernel``: it merges the partials over the split axis,

    m* = max_s m_s          l* = Σ_s l_s · exp(m_s − m*)
    o  = Σ_s acc_s · exp(m_s − m*) / max(l*, 1e-30)

Partition and partial contract are the JAX package's (`decode_partition`,
`_blocked_tables`), so the partials compare with the reference split by
split.  Each wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.kernels import use_kernel
from repro_torch.kernels.build import check, get_lib
from repro_torch.kernels.paged_attention.contracts import decode_partition

NEG_INF = -1e30

# dtype codes of the C interface
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DECODE_HEAD_DIMS = (64, 128)
DECODE_GROUPS = (1, 2, 4, 8)


def _combine_partials_plain(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """Plain combine epilogue (the ``_combine_partials_jnp`` counterpart,
    and the plain version of K2)."""
    m_g = m.amax(dim=2, keepdim=True)  # (B, Hkv, 1, G)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=2)  # (B, Hkv, G)
    o = (acc * corr[..., None]).sum(dim=2)  # (B, Hkv, G, D)
    return (o / torch.clamp(l_g, min=1e-30)[..., None]).to(dtype)


def combine_partials_kernel(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """K2: merge split-K partials, one CUDA block per (batch, kv_head).

    m, l: (B, Hkv, S, G) f32; acc: (B, Hkv, S, G, D) f32.  Returns
    (B, Hkv, G, D) in ``dtype`` (f32 or bf16).
    """
    if not use_kernel("combine_partials", m, l, acc):
        return _combine_partials_plain(m, l, acc, dtype)
    B, Hkv, S, G = m.shape
    D = acc.shape[-1]
    if dtype not in _Q_CODES:
        raise UnsupportedFeature(f"combine output dtype {dtype}",
                                 dtype=str(dtype))
    for name, t, shape in (("m", m, (B, Hkv, S, G)), ("l", l, (B, Hkv, S, G)),
                           ("acc", acc, (B, Hkv, S, G, D))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise EngineConfigError(f"combine_partials: {name} must be a "
                                    f"contiguous f32 {shape} tensor")
    out = torch.empty((B, Hkv, G, D), dtype=dtype, device=m.device)
    with torch.cuda.device(m.device):
        err = get_lib().combine_partials(
            _Q_CODES[dtype], m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr(), B, Hkv, S, G, D,
            torch.cuda.current_stream().cuda_stream)
    check(err, "combine_partials")
    combine_partials_kernel.launches += 1
    return out


combine_partials_kernel.launches = 0


def combine_partials(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                     dtype=torch.float32) -> torch.Tensor:
    """Merge split-K partials over the split axis (flash-decoding).

    K2 runs when more than one split is active.  A single split needs no
    cross-split correction: its epilogue is one squeeze + normalise.
    """
    if m.shape[2] > 1:
        return combine_partials_kernel(m, l, acc, dtype=dtype)
    return _combine_partials_plain(m, l, acc, dtype=dtype)


def _blocked_tables(block_tables: torch.Tensor, lens: torch.Tensor, *,
                    num_pages: int, page_size: int, window: int,
                    padded_pages: int, pages_per_block: int) -> torch.Tensor:
    """(B, max_pages) table → rank-clamped (B, n_blocks, ppb) page table.

    Dense path: slot ranks are clamped to the last live page of each row,
    so every dead entry repeats a live page and no lookup leaves the
    table.  Windowed path: every ring slot may be live, so only
    pad-clamp.  Physical ids are clamped into the pool (−1 → page 0).
    """
    B, max_pages = block_tables.shape
    safe = torch.clamp(block_tables.long(), 0, num_pages - 1)
    rank = torch.arange(padded_pages, device=block_tables.device)[None, :]
    if window > 0:
        rank = torch.clamp(rank, max=max_pages - 1).expand(B, padded_pages)
    else:
        n_live = torch.clamp(-(-lens.long() // page_size), min=1)
        rank = torch.minimum(rank, n_live[:, None] - 1)
        rank = torch.clamp(rank, max=max_pages - 1)
    flat = torch.gather(safe, 1, rank)
    return flat.reshape(B, padded_pages // pages_per_block, pages_per_block)


def ring_slot_positions(lens: torch.Tensor, page_size: int, ring: int,
                        n_slots: int) -> torch.Tensor:
    """Logical position held by each ring slot for a sliding-window cache.

    Slot s = (page j, offset o) holds the *latest* position p with
    (p // page_size) % ring == j and p % page_size == o and p < len.
    Returns (B, n_slots) positions (may exceed len-1 → dead, mask upstream).
    """
    s = torch.arange(n_slots, device=lens.device)
    j = s // page_size
    o = s % page_size
    L = lens[:, None].long()
    cur_page = torch.clamp(L - 1, min=0) // page_size
    lpage = cur_page - torch.remainder(cur_page - j, ring)  # floor mod
    pos = lpage * page_size + o
    pos = torch.where(pos >= L, pos - ring * page_size, pos)
    return pos  # negative ⇒ slot never written


def _token_live(lens: torch.Tensor, n_tokens: int, page_size: int,
                window: int) -> torch.Tensor:
    """(B, n_tokens) liveness of every table-rank token slot, as K1 masks
    it: ``pos < len`` (dense) or the ring-slot window mask."""
    t = torch.arange(n_tokens, device=lens.device)
    L = lens.long()[:, None]
    if window <= 0:
        return t[None, :] < L
    ring = -(-window // page_size) + 1
    pos = ring_slot_positions(lens, page_size, ring, n_tokens)
    return ((pos >= 0) & (pos < L) & (pos >= L - window)
            & (t // page_size < ring)[None, :])


def _paged_attention_partials_plain(q, k_pages, v_pages, block_tables, lens,
                                    *, scale, window, softcap, kv_scale,
                                    pages_per_block, num_splits):
    """Plain version of K1: the same gather, masks and per-split softmax
    partials, vectorised over every split at once."""
    B, n_kv, G, D = q.shape
    num_pages, page_size = k_pages.shape[:2]
    max_pages = block_tables.shape[1]
    ppb, _, S, bps = decode_partition(max_pages, pages_per_block, num_splits)
    padded = S * bps * ppb
    pages = _blocked_tables(block_tables, lens, num_pages=num_pages,
                            page_size=page_size, window=window,
                            padded_pages=padded, pages_per_block=ppb)
    T = bps * ppb * page_size  # tokens per split
    k = k_pages[pages.reshape(B, padded)].float().reshape(B, S, T, n_kv, D)
    v = v_pages[pages.reshape(B, padded)].float().reshape(B, S, T, n_kv, D)
    if kv_scale > 0:
        k = k * kv_scale
        v = v * kv_scale
    live = _token_live(lens, padded * page_size, page_size, window)
    live = live.reshape(B, 1, S, 1, T)

    s = torch.einsum("bkgd,bstkd->bksgt", q.float() * scale, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    neg = torch.tensor(NEG_INF, device=q.device)
    s = torch.where(live, s, neg)
    m = s.amax(dim=-1)  # (B, Hkv, S, G); NEG_INF for an empty split
    p = torch.where(live, torch.exp(s - m[..., None]),
                    torch.tensor(0.0, device=q.device))
    acc = torch.einsum("bksgt,bstkd->bksgd", p, v)
    return m, p.sum(dim=-1), acc


def paged_attention_partials(
    q: torch.Tensor,  # (B, n_kv, G, D)
    k_pages: torch.Tensor,  # (num_pages, P, n_kv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32 (may contain -1)
    lens: torch.Tensor,  # (B,) int32
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
    pages_per_block: int = 1,
    num_splits: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1: split-K partials ((B,n_kv,S,G) m, (B,n_kv,S,G) l,
    (B,n_kv,S,G,D) acc), all f32.

    q is f32 or bf16; the pools share its dtype, or are int8 with
    ``kv_scale > 0`` (dequantised in the kernel).
    """
    if not use_kernel("paged_attention_partials", q, k_pages, v_pages,
                      block_tables, lens):
        return _paged_attention_partials_plain(
            q, k_pages, v_pages, block_tables, lens, scale=scale,
            window=window, softcap=softcap, kv_scale=kv_scale,
            pages_per_block=pages_per_block, num_splits=num_splits)
    B, n_kv, G, D = q.shape
    num_pages, page_size = k_pages.shape[:2]
    max_pages = block_tables.shape[1]
    _check_decode_inputs(q, k_pages, v_pages, block_tables, lens, kv_scale)
    ppb, _, S, bps = decode_partition(max_pages, pages_per_block, num_splits)
    dev = q.device
    m = torch.empty((B, n_kv, S, G), dtype=torch.float32, device=dev)
    l = torch.empty((B, n_kv, S, G), dtype=torch.float32, device=dev)
    acc = torch.empty((B, n_kv, S, G, D), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = get_lib().paged_decode_partials(
            _Q_CODES[q.dtype], _KV_CODES[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lens.data_ptr(), m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            B, n_kv, G, D, num_pages, page_size, max_pages, ppb, S, bps,
            float(scale), int(window), float(softcap), float(kv_scale),
            torch.cuda.current_stream().cuda_stream)
    check(err, "paged_decode_partials")
    paged_attention_partials.launches += 1
    return m, l, acc


paged_attention_partials.launches = 0


def _check_decode_inputs(q, k_pages, v_pages, block_tables, lens, kv_scale):
    B, n_kv, G, D = q.shape
    if q.dtype not in _Q_CODES:
        raise UnsupportedFeature(f"decode kernel: q dtype {q.dtype}",
                                 dtype=str(q.dtype))
    if D not in DECODE_HEAD_DIMS or G not in DECODE_GROUPS:
        raise UnsupportedFeature(
            f"decode kernel takes head_dim in {DECODE_HEAD_DIMS} and GQA "
            f"group in {DECODE_GROUPS}, got D={D} G={G}", head_dim=D,
            group=G)
    pool = k_pages.shape
    if (k_pages.dim() != 4 or pool[2] != n_kv or pool[3] != D
            or v_pages.shape != pool):
        raise EngineConfigError(f"decode kernel: pools {tuple(pool)} / "
                                f"{tuple(v_pages.shape)} do not match q "
                                f"{tuple(q.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (q.dtype,
                                                                torch.int8):
        raise UnsupportedFeature(f"decode kernel: pool dtype {k_pages.dtype}"
                                 f" with q dtype {q.dtype}")
    if (k_pages.dtype == torch.int8) != (kv_scale > 0):
        raise EngineConfigError("decode kernel: int8 pools need "
                                "kv_scale > 0, other pools kv_scale == 0",
                                kv_scale=kv_scale)
    if (block_tables.dtype != torch.int32 or lens.dtype != torch.int32
            or block_tables.dim() != 2 or block_tables.shape[0] != B
            or tuple(lens.shape) != (B,)):
        raise EngineConfigError("decode kernel: tables must be (B, "
                                "max_pages) int32 and lens (B,) int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("lens", lens)):
        if not t.is_contiguous():
            raise EngineConfigError(f"decode kernel: {name} must be "
                                    "contiguous")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise EngineConfigError("decode kernel: pools must be 16-byte "
                                "aligned (16-byte vector loads)")


def paged_attention_kernel(
    q: torch.Tensor,  # (B, n_kv, G, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    lens: torch.Tensor,
    *,
    scale: float,
    window: int = 0,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
    pages_per_block: int = 1,
    num_splits: int = 1,
) -> torch.Tensor:
    """K1 partials followed by the split-K combine; (B, n_kv, G, D)."""
    m, l, acc = paged_attention_partials(
        q, k_pages, v_pages, block_tables, lens, scale=scale, window=window,
        softcap=softcap, kv_scale=kv_scale,
        pages_per_block=pages_per_block, num_splits=num_splits)
    return combine_partials(m, l, acc, dtype=q.dtype)
