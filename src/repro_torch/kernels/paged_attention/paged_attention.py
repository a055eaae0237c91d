"""Paged attention kernels K1, K2 and K3 and their plain versions.

K1 (``paged_attention_partials``, CUDA ``csrc/paged_decode.cu``) replaces
the TPU kernel ``repro/kernels/paged_attention/paged_attention.py::
_decode_kernel``: one CUDA block per ``(batch, kv_head, split)`` slot walks
its split's KV pages through the rank-clamped block table (K/V tiles by TMA
into a four-stage ring, four warps with their own online softmax, merged
once at the end) and emits the un-normalised online-softmax partials
``(m, l, acc)``.  K2 replaces ``_combine_kernel``: it merges the partials
over the split axis,

    m* = max_s m_s          l* = Σ_s l_s · exp(m_s − m*)
    o  = Σ_s acc_s · exp(m_s − m*) / max(l*, 1e-30)

in two places (``combine_partials_kernel``, ``csrc/combine.cu``).  The
decode op ``paged_attention_kernel`` launches K1's partials and then K2,
at every split count, from one C call (``paged_decode_attention``), with
its partials in one buffer.  ``combine_prefill_partials`` runs K2 on K3's
partials where they lie, writing (B, C, H, D) directly.  K2 takes its
partials and its output by strides, so the decode layout is K3's with one
Q-block of one token.  ``combine_partials_kernel`` counts its launches per
layout (``launches_by_route``: "decode", "prefill", and "dist" for the
merge across ranks).

K3 (``paged_prefill_partials``, ``csrc/paged_prefill.cu``) replaces
``_prefill_kernel``: chunked paged prefill, the same partials over Q-blocks
of ``q_block·G`` rows that attend causally, by absolute position, to the
cached prefix and the chunk itself.  Every input of K3 runs on the tensor
cores, on one of two
tiles chosen by the q dtype (``prefill_route``): bf16 q on the bf16 tile
(``paged_prefill_kernel_tc``, wgmma), f32 q on the split-TF32 tile
(``paged_prefill_kernel_tf32``: every product as three TF32 products,
which keeps the f32 tolerance).  Each takes pools of q's dtype or int8
pools, and pages of any size: a page is one TMA box at a stage row that is
a multiple of 8 (the 128-byte swizzle's 1024-byte period); when the page
is not a multiple of 8 tokens the rows between boxes are masked per
element, and a page longer than a tile's K/V stage (`kernels.tile_keys`)
is cut into boxes of that many rows.  What limits the page is the tensor
map's 32-bit row coordinate: ``num_pages·page_size`` must stay below
2^31.  On int8 pools each tile is widened into a working stage of the
tile's element type, where the int8 values are exact (bf16 and TF32 hold
8-bit integers), and ``kv_scale`` is folded into the score scale and
into ``acc`` after the products: closer to exact than the JAX reference's
``bf16(k·kv_scale)`` for bf16 q (``repro/kernels/paged_attention/
ref.py``), and on the split-TF32 tile two TF32 products in place of three
(K and V have no low part).  Each tile and input variant ("tc",
"tc/int8", "tc/odd", "tc/int8/odd" and the same of "tf32x3") counts its
own launches in ``paged_prefill_partials.launches_by_route``.

Partition and partial contract are the JAX package's (`decode_partition`,
`_blocked_tables`), so the partials compare with the reference split by
split.  Each wrapper runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors; it never falls back.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch

from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.kernels import (HEAD_DIMS, check_head_dim, dry_tally,
                                  tensor_core_p, tf32_product, use_kernel)
from repro_torch.kernels.build import check, get_lib
from repro_torch.kernels.paged_attention.contracts import decode_partition

NEG_INF = -1e30

# dtype codes of the C interface
_Q_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DECODE_GROUP_WIDTHS = (1, 2, 4, 8)  # K1's compiled query heads per warp
_DECODE_MAX_CTA_GROUP = 16  # query heads of one K1 CTA, at most
# K3's tiles by q dtype, and their input variants: int8 pools, and pages
# that are not a multiple of 8 tokens (the rows between boxes masked)
_TILE_BY_Q = {torch.bfloat16: "tc", torch.float32: "tf32x3"}
ROUTES = tuple(f"{tile}{i8}{odd}" for tile in ("tc", "tf32x3")
               for i8 in ("", "/int8") for odd in ("", "/odd"))
_MAX_POOL_ROWS = 2 ** 31  # the tensor map's row coordinate is a 32-bit int


def prefill_route(q_dtype: torch.dtype, kv_dtype: torch.dtype,
                  page_size: int) -> str:
    """K3's tile and input variant: "tc" (the bf16 tensor-core tile) for
    bf16 q, "tf32x3" (the split-TF32 tile) for f32 q, with "/int8" for
    int8 pools and "/odd" for a page that is not a multiple of 8 tokens.
    Pools of another dtype than q's or int8, or a page below 1 token, take
    no tile and raise ``UnsupportedFeature``."""
    tile = _TILE_BY_Q.get(q_dtype)
    if tile is None or kv_dtype not in (q_dtype, torch.int8) or page_size < 1:
        raise UnsupportedFeature(
            f"prefill kernel: q {q_dtype}, pools {kv_dtype}, page "
            f"{page_size} (takes f32 or bf16 q over pools of its dtype or "
            "int8, pages >= 1)", dtype=str(q_dtype))
    return (tile + ("/int8" if kv_dtype == torch.int8 else "")
            + ("/odd" if page_size % 8 else ""))


def _combine_partials_plain(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor,
                            dtype=torch.float32) -> torch.Tensor:
    """Plain combine epilogue (the ``_combine_partials_jnp`` counterpart,
    and the plain version of K2 at the decode layout)."""
    m_g = m.amax(dim=2, keepdim=True)  # (B, Hkv, 1, G)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=2)  # (B, Hkv, G)
    o = (acc * corr[..., None]).sum(dim=2)  # (B, Hkv, G, D)
    return (o / torch.clamp(l_g, min=1e-30)[..., None]).to(dtype)


def _combine_prefill_plain(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor, C: int, q_block: int,
                           dtype=torch.float32) -> torch.Tensor:
    """Plain version of K2 at K3's layout (the JAX
    ``combine_prefill_partials``): m, l (B, Hkv, NQ, S, R), acc (B, Hkv,
    NQ, S, R, D) reduced over S with K2's formula; row ``r`` of Q-block
    ``nq`` is token ``nq·q_block + r // G`` of head ``h·G + r % G``, tokens
    past ``C`` dropped.  Returns (B, C, H, D) in ``dtype``."""
    B, n_kv, NQ, S, R = m.shape
    D = acc.shape[-1]
    G = R // q_block
    m_g = m.amax(dim=3, keepdim=True)
    corr = torch.exp(m - m_g)
    l_g = (l * corr).sum(dim=3)  # (B, Hkv, NQ, R)
    o = (acc * corr[..., None]).sum(dim=3)  # (B, Hkv, NQ, R, D)
    o = (o / torch.clamp(l_g, min=1e-30)[..., None]).to(dtype)
    o = o.reshape(B, n_kv, NQ, q_block, G, D).permute(0, 2, 3, 1, 4, 5)
    return o.reshape(B, NQ * q_block, n_kv * G, D)[:, :C]


def _check_partials(m, l, acc):
    """m, l f32 of one shape and strides, acc f32 of that shape and D with
    unit column stride: what K2 takes."""
    if (m.dtype != torch.float32 or l.dtype != torch.float32
            or acc.dtype != torch.float32 or m.shape != l.shape
            or m.stride() != l.stride() or acc.shape[:-1] != m.shape
            or acc.stride(-1) != 1):
        raise EngineConfigError(
            "combine: m and l must be f32 of one shape and strides, acc f32 "
            f"of that shape by D with unit column stride (m {tuple(m.shape)} "
            f"{m.dtype}, l {tuple(l.shape)}, acc {tuple(acc.shape)} "
            f"{acc.dtype})")


def combine_cost(rows: int, S: int, D: int, out_item: int):
    """K2's (operations, bytes) for ``rows`` output rows of head dim ``D``
    merged over ``S`` splits: 4 operations per partial ``acc`` element;
    the partials (m, l, acc: S·(D + 2) f32 per row) read once and the
    output (``out_item`` bytes per element) written once."""
    return 4 * rows * S * D, rows * S * (D + 2) * 4 + rows * D * out_item


def _launch_combine(m, l, acc, out, dims, strides, route):
    """K2 on CUDA tensors into ``out`` (f32 or bf16): ``dims`` (B, Hkv, NQ,
    S, R, D, G, q_block, C) and ``strides``, the element strides of m and l
    (b, h, nq, s, r), of acc (the same; d is 1) and of the output (b,
    token, head; d is 1).  Counts one launch of ``route``.  In dry mode
    (fake tensors) K2 stands in here, after the wrapper's checks and
    allocations: its operations and bytes go to the tally instead."""
    tally = dry_tally(m)
    if tally is not None:
        B, Hkv, NQ, S, R, D = dims[:6]
        ops, nbytes = combine_cost(B * Hkv * NQ * R, S, D, 0)
        tally.add(("combine", f"combine/{route}"), ops,
                  nbytes + out.numel() * out.element_size())
        return out
    dev = m.device
    guard = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        err = get_lib().combine_partials(
            _Q_CODES[out.dtype], m.data_ptr(), l.data_ptr(), acc.data_ptr(),
            out.data_ptr(), *dims, *strides,
            torch._C._cuda_getCurrentRawStream(dev.index))
    check(err, "combine_partials")
    combine_partials_kernel.launches += 1
    combine_partials_kernel.launches_by_route[route] += 1
    return out


def combine_partials_kernel(m: torch.Tensor, l: torch.Tensor,
                            acc: torch.Tensor, dtype=torch.float32,
                            route: str = "decode") -> torch.Tensor:
    """K2 at the decode layout: m, l (B, Hkv, S, G) f32; acc (B, Hkv, S, G,
    D) f32.  Returns (B, Hkv, G, D) in ``dtype`` (f32 or bf16).  ``route``
    names the launch in ``launches_by_route``: "decode", or "dist" for the
    merge of every rank's partials (``distributed.collectives``)."""
    if not use_kernel("combine_partials", m, l, acc):
        return _combine_partials_plain(m, l, acc, dtype)
    _check_partials(m, l, acc)
    if dtype not in _Q_CODES:
        raise UnsupportedFeature(f"combine output dtype {dtype}",
                                 dtype=str(dtype))
    B, Hkv, S, G = m.shape
    D = acc.shape[-1]
    out = torch.empty((B, Hkv, G, D), dtype=dtype, device=m.device)
    # one Q-block of one token: R = G rows, output (B, 1, Hkv·G, D)
    mb, mh, ms, mg = m.stride()
    ab, ah, as_, ag = acc.stride()[:4]
    _launch_combine(m, l, acc, out, (B, Hkv, 1, S, G, D, G, 1, 1),
                    (mb, mh, 0, ms, mg, ab, ah, 0, as_, ag,
                     Hkv * G * D, 0, D), route)
    return out


combine_partials_kernel.launches = 0
combine_partials_kernel.launches_by_route = dict.fromkeys(
    ("decode", "prefill", "dist"), 0)


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


def _work_dtype(q: torch.Tensor) -> torch.dtype:
    """The plain versions' arithmetic: f32, or f64 for f64 inputs (the
    card's check evaluates them in f64 to see which side carries an
    error)."""
    return torch.float64 if q.dtype == torch.float64 else torch.float32


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
    work = _work_dtype(q)
    k = k_pages[pages.reshape(B, padded)].to(work).reshape(B, S, T, n_kv, D)
    v = v_pages[pages.reshape(B, padded)].to(work).reshape(B, S, T, n_kv, D)
    if kv_scale > 0:
        k = k * kv_scale
        v = v * kv_scale
    live = _token_live(lens, padded * page_size, page_size, window)
    live = live.reshape(B, 1, S, 1, T)

    s = torch.einsum("bkgd,bstkd->bksgt", q.to(work) * scale, k)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    neg = torch.tensor(NEG_INF, device=q.device)
    s = torch.where(live, s, neg)
    m = s.amax(dim=-1)  # (B, Hkv, S, G); NEG_INF for an empty split
    p = torch.where(live, torch.exp(s - m[..., None]),
                    torch.tensor(0.0, device=q.device))
    acc = torch.einsum("bksgt,bstkd->bksgd", p, v)
    return m, p.sum(dim=-1), acc


def _scratch_views(buf, B, n_kv, S, G, D):
    """K1's outputs ``m``, ``l`` (B, n_kv, S, G) and ``acc`` (B, n_kv, S,
    G, D), f32, as contiguous views of one buffer (m first, then l, then
    acc): one allocation per decode op instead of three."""
    n = B * n_kv * S * G
    return (buf[:n].view(B, n_kv, S, G), buf[n:2 * n].view(B, n_kv, S, G),
            buf[2 * n:].view(B, n_kv, S, G, D))


def _decode_call(q, k_pages, v_pages, block_tables, lens, *, scale, window,
                 softcap, kv_scale, pages_per_block, num_splits, combine):
    """The host's work before one decode launch: the input checks (once),
    the partition, one buffer for (m, l, acc) addressed by offsets, the
    output when K2 runs (``combine``), and the C entry's name and arguments
    but the stream.  Returns ``(name, args, buf, S, out)``; see
    `_scratch_views` for ``buf``.  In dry mode (fake tensors) K1, and K2
    when ``combine``, stand in here, after the checks and allocations:
    their operations and bytes go to the tally, each row's live tokens at
    their upper bound (the table's capacity, or the window), and ``name``
    is None."""
    B, n_kv, G, D = q.shape
    num_pages, page_size = k_pages.shape[:2]
    max_pages = block_tables.shape[1]
    _check_decode_inputs(q, k_pages, v_pages, block_tables, lens, kv_scale)
    ppb, _, S, bps = decode_partition(max_pages, pages_per_block, num_splits)
    dev = q.device
    n = B * n_kv * S * G
    buf = torch.empty(n * (D + 2), dtype=torch.float32, device=dev)
    out = (torch.empty((B, n_kv, G, D), dtype=q.dtype, device=dev)
           if combine else None)
    tally = dry_tally(q)
    if tally is not None:
        cap = max_pages * page_size
        per_row = min(cap, window) if window > 0 else cap
        tally.add(("paged_decode",), *decode_cost(
            q.shape, S, max_pages, B * per_row, q.element_size(),
            k_pages.element_size()))
        if combine:
            tally.add(("combine", "combine/decode"),
                      *combine_cost(B * n_kv * G, S, D, q.element_size()))
        return None, (), buf, S, out
    _check_aligned("decode kernel", q, k_pages, v_pages)
    base = buf.data_ptr()
    head = (_Q_CODES[q.dtype], _KV_CODES[k_pages.dtype], q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            lens.data_ptr(), base, base + 4 * n, base + 8 * n)
    tail = (B, n_kv, G, D, num_pages, page_size, max_pages, ppb, S, bps,
            float(scale), int(window), float(softcap), float(kv_scale))
    if combine:
        return ("paged_decode_attention", (*head, out.data_ptr(), *tail), buf,
                S, out)
    return "paged_decode_partials", (*head, *tail), buf, S, None


def decode_cost(q_shape, S: int, max_pages: int, live: int, q_item: int,
                kv_item: int):
    """K1's (operations, bytes) for q of ``q_shape`` (B, n_kv, G, D) over
    ``live`` live tokens in all (the rows' lengths summed, or their upper
    bound) in ``S`` splits: 4·D operations per live token and query head;
    the live K and V rows, q, the tables ((B, ``max_pages``) int32) and
    lens read once, the partials (B·n_kv·S·G·(D + 2) f32) written once."""
    B, n_kv, G, D = q_shape
    ops = 4 * live * n_kv * G * D
    nbytes = (2 * live * n_kv * D * kv_item + B * n_kv * G * D * q_item
              + B * max_pages * 4 + B * 4 + B * n_kv * S * G * (D + 2) * 4)
    return ops, nbytes


def _launch_decode(q, k_pages, v_pages, block_tables, lens, **kw):
    """K1 on CUDA tensors, followed by K2 when ``combine``, from one C call
    (``paged_decode_attention``; K1 alone is ``paged_decode_partials``) on
    the raw current stream.  The decode step calls it once per layer, so
    the host's work is kept to `_decode_call`.  Returns ``(buf, S, out)``;
    ``out`` is None unless K2 ran (or, in dry mode, stood in)."""
    name, args, buf, S, out = _decode_call(q, k_pages, v_pages, block_tables,
                                           lens, **kw)
    if name is None:
        return buf, S, out
    dev = q.device
    lib = get_lib()
    guard = (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
             else contextlib.nullcontext())
    with guard:
        err = getattr(lib, name)(
            *args, torch._C._cuda_getCurrentRawStream(dev.index))
    check(err, name)
    paged_attention_partials.launches += 1
    if out is not None:
        combine_partials_kernel.launches += 1
        combine_partials_kernel.launches_by_route["decode"] += 1
    return buf, S, out


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
    kw = dict(scale=scale, window=window, softcap=softcap, kv_scale=kv_scale,
              pages_per_block=pages_per_block, num_splits=num_splits)
    if not use_kernel("paged_attention_partials", q, k_pages, v_pages,
                      block_tables, lens):
        return _paged_attention_partials_plain(q, k_pages, v_pages,
                                               block_tables, lens, **kw)
    buf, S, _ = _launch_decode(q, k_pages, v_pages, block_tables, lens,
                               combine=False, **kw)
    B, n_kv, G, D = q.shape
    return _scratch_views(buf, B, n_kv, S, G, D)


paged_attention_partials.launches = 0


def _check_paged_inputs(kernel, q, n_kv, D, k_pages, v_pages, block_tables,
                        vectors, kv_scale):
    """Checks K1 and K3 share: q dtype, pools against (n_kv, D), pool
    dtype and ``kv_scale``, int32 tables and (B,) int32 ``vectors``, and
    contiguity: every check but the pointers' (`_check_aligned`)."""
    B = q.shape[0]
    if q.dtype not in _Q_CODES:
        raise UnsupportedFeature(f"{kernel}: q dtype {q.dtype}",
                                 dtype=str(q.dtype))
    pool = k_pages.shape
    if (k_pages.dim() != 4 or pool[2] != n_kv or pool[3] != D
            or v_pages.shape != pool):
        raise EngineConfigError(f"{kernel}: pools {tuple(pool)} / "
                                f"{tuple(v_pages.shape)} do not match q "
                                f"{tuple(q.shape)}")
    if k_pages.dtype != v_pages.dtype or k_pages.dtype not in (q.dtype,
                                                                torch.int8):
        raise UnsupportedFeature(f"{kernel}: pool dtype {k_pages.dtype}"
                                 f" with q dtype {q.dtype}")
    if (k_pages.dtype == torch.int8) != (kv_scale > 0):
        raise EngineConfigError(f"{kernel}: int8 pools need kv_scale > 0, "
                                "other pools kv_scale == 0",
                                kv_scale=kv_scale)
    if (block_tables.dtype != torch.int32 or block_tables.dim() != 2
            or block_tables.shape[0] != B
            or any(v.dtype != torch.int32 or tuple(v.shape) != (B,)
                   for v in vectors.values())):
        raise EngineConfigError(f"{kernel}: tables must be (B, max_pages) "
                                f"int32 and {', '.join(vectors)} (B,) int32")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), *vectors.items()):
        if not t.is_contiguous():
            raise EngineConfigError(f"{kernel}: {name} must be contiguous")


def _check_aligned(kernel, q, k_pages, v_pages):
    """The 16-byte alignment of q and the pools that K1's and K3's vector
    loads and TMA need: a check of pointers, made just before the launch
    (a fake tensor in dry mode has none)."""
    if q.data_ptr() % 16 or k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise EngineConfigError(f"{kernel}: q and the pools must be 16-byte "
                                "aligned (16-byte vector loads and TMA)")


def _check_decode_inputs(q, k_pages, v_pages, block_tables, lens, kv_scale):
    B, n_kv, G, D = q.shape
    check_head_dim("decode kernel", D)
    _check_paged_inputs("decode kernel", q, n_kv, D, k_pages, v_pages,
                        block_tables, {"lens": lens}, kv_scale)
    if not decode_supported(k_pages.dtype, D, G, k_pages.shape[1]):
        raise UnsupportedFeature(
            f"decode kernel: pools of {k_pages.dtype}, D={D}, G={G}, page "
            f"{k_pages.shape[1]}", head_dim=D, group=G)


def decode_supported(kv_dtype: torch.dtype, D: int, G: int,
                     page_size: int) -> bool:
    """Whether K1 takes pools of ``kv_dtype`` (f32, bf16 or int8) with
    pages of ``page_size`` rows of head dim ``D`` for a GQA group of ``G``
    query heads: any G >= 1 (`decode_group_plan`), D in ``HEAD_DIMS``, any
    page (a page shorter than K1's tile is one TMA box at a 128-byte
    aligned stage offset, so odd int8 pages at D = 64 fit too).  The C
    entry refuses the same shapes."""
    return (kv_dtype in _KV_CODES and D in HEAD_DIMS and G >= 1
            and page_size >= 1)


def decode_group_plan(G: int) -> Tuple[int, int, int, int]:
    """How K1 cuts a group of ``G`` query heads (``plan`` in
    csrc/paged_decode.cu): ``(gw, slices, chunks, gc)``.  The group is cut
    into ``chunks`` of ``gc`` heads over the grid (one chunk up to 16
    heads, so one pass over the kv head's K/V; each more chunk reads it
    again); a chunk runs in ``slices`` groups of four warps, each keeping
    ``gw`` heads (1, 2 or 4 heads in one slice of the next width up; 5..8
    in two slices of 4; 9..16 in two of 8), the heads past ``gc`` dead."""
    if G < 1:
        raise UnsupportedFeature(f"decode kernel: GQA group {G}", group=G)
    chunks = -(-G // _DECODE_MAX_CTA_GROUP)
    gc = -(-G // chunks)
    if gc <= 4:
        return (1 if gc == 1 else 2 if gc == 2 else 4), 1, chunks, gc
    return (4 if gc <= 8 else 8), 2, chunks, gc


def decode_smem_bytes(kv_dtype: torch.dtype, D: int, G: int) -> int:
    """K1's dynamic shared memory for a group of ``G`` heads, computed as
    ``smem_bytes`` in csrc/paged_decode.cu: four stages of K and V tiles
    (the largest power of two of rows, at most 32, that fits 8 KB each),
    the merge of four warps' (m, l, acc) per head of the CTA, barriers and
    128 bytes of slack."""
    gw, slices, _, _ = decode_group_plan(G)
    row = D * kv_dtype.itemsize
    tile = min(32, 16384 // (2 * row))
    tile = 1 << (tile.bit_length() - 1)
    return 128 + 4 * 2 * tile * row + 4 * slices * gw * (D + 2) * 4 + 64


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
    """The decode op: K1's partials merged over the splits; (B, n_kv, G, D)
    in the q dtype.  On CUDA tensors one C call launches K1 and K2 after
    it, at every split count."""
    kw = dict(scale=scale, window=window, softcap=softcap, kv_scale=kv_scale,
              pages_per_block=pages_per_block, num_splits=num_splits)
    if not use_kernel("paged_attention_kernel", q, k_pages, v_pages,
                      block_tables, lens):
        m, l, acc = _paged_attention_partials_plain(q, k_pages, v_pages,
                                                    block_tables, lens, **kw)
        return _combine_partials_plain(m, l, acc, dtype=q.dtype)
    return _launch_decode(q, k_pages, v_pages, block_tables, lens,
                          combine=True, **kw)[2]


# -- K3: chunked paged prefill ------------------------------------------------
def _prefill_q_blocks(q: torch.Tensor, n_kv: int, q_block: int
                      ) -> Tuple[torch.Tensor, int]:
    """(B, C, H, D) chunk queries → (B, n_kv, NQ, q_block·G, D) row blocks.

    Row ``r`` of a block is chunk token ``r // G``, head group ``r % G``;
    the chunk is zero-padded to ``NQ·q_block`` tokens.  K3 indexes the
    chunk queries in place and needs no such copy; its plain version and
    the oracle use this layout.
    """
    B, C, H, D = q.shape
    G = H // n_kv
    nq = -(-C // q_block)
    qpad = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * q_block - C))
    qb = qpad.reshape(B, nq, q_block, n_kv, G, D).permute(0, 3, 1, 2, 4, 5)
    return qb.reshape(B, n_kv, nq, q_block * G, D), nq


def combine_prefill_partials(m: torch.Tensor, l: torch.Tensor,
                             acc: torch.Tensor, C: int, q_block: int, *,
                             dtype=torch.float32) -> torch.Tensor:
    """Merge chunked-prefill split-K partials into (B, C, H, D).

    m, l: (B, Hkv, NQ, S, R); acc: (B, Hkv, NQ, S, R, D) with
    ``R = q_block·G``.  On CUDA tensors K2 reads them where they lie and
    writes (B, C, H, D) in ``dtype`` once, at every S (route "prefill");
    on CPU tensors `_combine_prefill_plain` computes the same function.
    """
    if not use_kernel("combine_prefill_partials", m, l, acc):
        return _combine_prefill_plain(m, l, acc, C, q_block, dtype)
    _check_partials(m, l, acc)
    if dtype not in _Q_CODES:
        raise UnsupportedFeature(f"combine output dtype {dtype}",
                                 dtype=str(dtype))
    B, n_kv, NQ, S, R = m.shape
    D = acc.shape[-1]
    G = R // q_block
    if R != q_block * G:
        raise EngineConfigError(f"combine: {R} rows per Q-block are not "
                                f"q_block {q_block} times a group")
    out = torch.empty((B, C, n_kv * G, D), dtype=dtype, device=m.device)
    _launch_combine(m, l, acc, out, (B, n_kv, NQ, S, R, D, G, q_block, C),
                    (*m.stride(), *acc.stride()[:5], *out.stride()[:3]),
                    "prefill")
    return out


def _paged_prefill_partials_plain(q, k_pages, v_pages, block_tables, kv_lens,
                                  q_start, *, scale, softcap, kv_scale,
                                  pages_per_block, num_splits, q_block,
                                  p_terms=None, tf32_terms=None):
    """Plain version of K3: the same Q-block rows, gather, causal and
    length masks and per-split softmax partials, vectorised over every
    Q-block and split at once.  Skipped KV blocks are all-masked here,
    which leaves the partials exactly as skipping does.  On int8 pools
    (``kv_scale > 0``) K and V stay the integers they are and
    ``kv_scale`` is folded in after the products, as the kernel folds it:
    ``s = (q·k)·scale·kv_scale``, ``acc = (p·v)·kv_scale``.
    ``p_terms`` rounds the probabilities before p.V to that many bf16
    terms, as the bf16 tensor-core kernel feeds them (2: hi + lo); None
    keeps them f32, and ``l`` sums them in f32 either way.  ``tf32_terms``
    (3 or 1) evaluates q.K and p.V as the split-TF32 kernel does
    (`tf32_product`; the scale applies after q.K there); on int8 pools 3
    becomes 2, the kernel's two products against the exact K and V."""
    B, C, H, D = q.shape
    num_pages, page_size, n_kv, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    G = H // n_kv
    ppb, _, S, bps = decode_partition(max_pages, pages_per_block, num_splits)
    padded = S * bps * ppb
    pages = _blocked_tables(block_tables, kv_lens, num_pages=num_pages,
                            page_size=page_size, window=0,
                            padded_pages=padded, pages_per_block=ppb)
    T = bps * ppb * page_size  # tokens per split
    work = _work_dtype(q)
    k = k_pages[pages.reshape(B, padded)].to(work).reshape(B, S, T, n_kv, D)
    v = v_pages[pages.reshape(B, padded)].to(work).reshape(B, S, T, n_kv, D)
    fold = kv_scale > 0
    if fold and tf32_terms == 3:
        tf32_terms = 2
    qb, NQ = _prefill_q_blocks(q, n_kv, q_block)
    dev = q.device
    kvpos = torch.arange(padded * page_size, device=dev).reshape(S, T)
    tok = (torch.arange(NQ, device=dev)[:, None] * q_block
           + torch.arange(q_block * G, device=dev)[None, :] // G)
    qpos = q_start.long()[:, None, None] + tok[None]  # (B, NQ, R)
    live = ((kvpos[None] < kv_lens.long()[:, None, None])[:, None, :, None]
            & (kvpos[None, None, :, None, :]
               <= qpos[:, :, None, :, None]))  # (B, NQ, S, R, T)
    live = live[:, None]

    qk = "bknrd,bstkd->bknsrt"
    if tf32_terms:
        s = tf32_product(lambda a, b: torch.einsum(qk, a, b), qb.to(work),
                         k, tf32_terms) * scale
    elif fold:
        s = torch.einsum(qk, qb.to(work), k) * scale
    else:
        s = torch.einsum(qk, qb.to(work) * scale, k)
    if fold:
        s = s * kv_scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(live, s, torch.tensor(NEG_INF, device=dev))
    m = s.amax(dim=-1)  # (B, Hkv, NQ, S, R); NEG_INF where nothing is live
    p = torch.where(live, torch.exp(s - m[..., None]),
                    torch.tensor(0.0, device=dev))
    pv = "bknsrt,bstkd->bknsrd"
    if tf32_terms:
        acc = tf32_product(lambda a, b: torch.einsum(pv, a, b), p, v,
                           tf32_terms)
    else:
        acc = torch.einsum(pv, tensor_core_p(p, p_terms), v)
    if fold:
        acc = acc * kv_scale
    return m, p.sum(dim=-1), acc


def prefill_cost(q_shape, n_kv: int, keys: int, kv_tokens: int,
                 max_pages: int, partial_bytes: int, q_item: int,
                 kv_item: int):
    """K3's (operations, bytes) for chunk queries of ``q_shape`` (B, C, H,
    D): 4·D operations per (query row, live key) pair and head, ``keys``
    pairs in all; q, the ``kv_tokens`` live K/V rows of ``n_kv`` heads,
    the tables ((B, ``max_pages``) int32), kv_lens and q_start read once,
    the partials (``partial_bytes``) written once."""
    B, C, H, D = q_shape
    ops = 4 * D * H * keys
    nbytes = (B * C * H * D * q_item + 2 * kv_tokens * n_kv * D * kv_item
              + B * max_pages * 4 + 2 * B * 4 + partial_bytes)
    return ops, nbytes


def paged_prefill_partials(
    q: torch.Tensor,  # (B, C, n_heads, D) — one prompt chunk per sequence
    k_pages: torch.Tensor,  # (num_pages, P, n_kv, D)
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,  # (B, max_pages) int32 (may contain -1)
    kv_lens: torch.Tensor,  # (B,) int32 cached tokens incl. the chunk
    q_start: torch.Tensor,  # (B,) int32 absolute position of chunk token 0
    *,
    scale: float,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
    pages_per_block: int = 1,
    num_splits: int = 1,
    q_block: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: chunked-prefill split-K partials ((B,Hkv,NQ,S,R) m and l,
    (B,Hkv,NQ,S,R,D) acc), all f32, with ``NQ = ceil(C / q_block)`` and
    ``R = q_block·G`` — shaped for `combine_prefill_partials`.

    The chunk's K/V must already be in the pages (write-then-attend, on
    the same stream).  q is f32 or bf16; the pools share its dtype, or are
    int8 with ``kv_scale > 0``; pages of any size.
    """
    if not use_kernel("paged_prefill_partials", q, k_pages, v_pages,
                      block_tables, kv_lens, q_start):
        return _paged_prefill_partials_plain(
            q, k_pages, v_pages, block_tables, kv_lens, q_start, scale=scale,
            softcap=softcap, kv_scale=kv_scale,
            pages_per_block=pages_per_block, num_splits=num_splits,
            q_block=q_block)
    B, C, H, D = q.shape
    num_pages, page_size, n_kv = k_pages.shape[:3]
    check_head_dim("prefill kernel", D)
    if H % max(n_kv, 1) or q_block < 1:
        raise UnsupportedFeature(
            f"prefill kernel takes heads a multiple of the kv heads and "
            f"q_block >= 1, got H={H} n_kv={n_kv} q_block={q_block}",
            q_block=q_block)
    _check_paged_inputs("prefill kernel", q, n_kv, D, k_pages, v_pages,
                        block_tables, {"kv_lens": kv_lens,
                                       "q_start": q_start}, kv_scale)
    G = H // n_kv
    ppb, _, S, bps = decode_partition(block_tables.shape[1], pages_per_block,
                                      num_splits)
    pages = _blocked_tables(block_tables, kv_lens, num_pages=num_pages,
                            page_size=page_size, window=0,
                            padded_pages=S * bps * ppb, pages_per_block=ppb
                            ).int()
    NQ, R = -(-C // q_block), q_block * G
    route = prefill_route(q.dtype, k_pages.dtype, page_size)
    if num_pages * page_size >= _MAX_POOL_ROWS:
        raise UnsupportedFeature(
            f"prefill kernel: a pool of {num_pages} pages of {page_size} "
            f"tokens has 2^31 rows or more (the tensor map's row coordinate"
            " is 32-bit)", page_size=page_size)
    dev = q.device
    m = torch.empty((B, n_kv, NQ, S, R), dtype=torch.float32, device=dev)
    l = torch.empty((B, n_kv, NQ, S, R), dtype=torch.float32, device=dev)
    acc = torch.empty((B, n_kv, NQ, S, R, D), dtype=torch.float32,
                      device=dev)
    tally = dry_tally(q)
    if tally is not None:  # dry mode: every row's keys at the capacity
        max_pages = block_tables.shape[1]
        cap = max_pages * page_size
        tally.add(("paged_prefill", f"paged_prefill/{route}"), *prefill_cost(
            q.shape, n_kv, B * C * cap, B * cap, max_pages,
            4 * (m.numel() + l.numel() + acc.numel()), q.element_size(),
            k_pages.element_size()))
        return m, l, acc
    _check_aligned("prefill kernel", q, k_pages, v_pages)
    name = "paged_prefill_partials_" + ("tc" if route.startswith("tc")
                                        else "tf32")
    with torch.cuda.device(dev):
        err = getattr(get_lib(), name)(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            pages.data_ptr(), kv_lens.data_ptr(), q_start.data_ptr(),
            m.data_ptr(), l.data_ptr(), acc.data_ptr(), B, C, n_kv, G, D,
            num_pages, page_size, S * bps, ppb, S, bps, q_block,
            float(scale), float(softcap), float(kv_scale),
            torch.cuda.current_stream().cuda_stream)
    check(err, name)
    paged_prefill_partials.launches += 1
    paged_prefill_partials.launches_by_route[route] += 1
    return m, l, acc


paged_prefill_partials.launches = 0
paged_prefill_partials.launches_by_route = dict.fromkeys(ROUTES, 0)


def paged_prefill_kernel(
    q: torch.Tensor,  # (B, C, n_heads, D)
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    block_tables: torch.Tensor,
    kv_lens: torch.Tensor,
    q_start: torch.Tensor,
    *,
    scale: float,
    softcap: float = 0.0,
    kv_scale: float = 0.0,
    pages_per_block: int = 1,
    num_splits: int = 1,
    q_block: int = 1,
) -> torch.Tensor:
    """K3 partials followed by the shared combine; (B, C, n_heads, D)."""
    m, l, acc = paged_prefill_partials(
        q, k_pages, v_pages, block_tables, kv_lens, q_start, scale=scale,
        softcap=softcap, kv_scale=kv_scale, pages_per_block=pages_per_block,
        num_splits=num_splits, q_block=q_block)
    return combine_prefill_partials(m, l, acc, q.shape[1], q_block,
                                    dtype=q.dtype)
