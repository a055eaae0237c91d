"""GQA attention layer: projections + RoPE around the core attention ops
(port of ``repro.models.attention``: attention over whole sequences
without a cache, prefill, chunked prefill and decode, over the paged
pools or the contiguous baseline's buffers; and cross-attention over
per-request image or audio K/V).

The KV caches are updated **in place**: ``attn_prefill``,
``attn_prefill_chunked`` and ``attn_decode`` scatter the new K/V into the
pools they are given, ``attn_prefill_contiguous`` and
``attn_decode_contiguous`` store it by position in the max-length
buffers; all return only the layer output.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as core_attn
from repro_torch.core import cache as kvcache
from repro_torch.models import layers
from repro_torch.models.layers import apply_rope
from repro_torch.models.spec import ParamSpec


def attn_spec(cfg: ModelConfig) -> Dict:
    d, H, Hkv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                     cfg.resolved_head_dim)
    return {
        "wq": ParamSpec((d, H, hd), ("embed", "heads", None)),
        "wk": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, Hkv, hd), ("embed", "kv_heads", None)),
        "wo": ParamSpec((H, hd, d), ("heads", None, "embed")),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") as one matmul."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _qkv(p: Dict, x: torch.Tensor, positions: Optional[torch.Tensor],
         theta: float, ws: Tuple[str, ...] = ()
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k and v of ``x``, rotated at ``positions``.  ``ws``
    (``TPLayout.act_embed``): ``x`` holds the rank's columns of ``embed``
    and the weights their rows (``layers.ws_pieces``): the three f32
    partials are summed over those axes in one all-reduce
    (``layers.ws_contract``) before RoPE."""
    if ws:
        flat = [p[k].reshape(p[k].shape[0], -1) for k in ("wq", "wk", "wv")]
        q, k, v = (t.reshape(*x.shape[:-1], *p[n].shape[1:]) for t, n in zip(
            layers.ws_contract(x, flat, ws), ("wq", "wk", "wv")))
    else:
        q = _proj(x, p["wq"])
        k = _proj(x, p["wk"])
        v = _proj(x, p["wv"])
    if positions is not None:
        q = apply_rope(q, positions, theta)
        k = apply_rope(k, positions, theta)
    return q, k, v


def kv_quant(cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Quantize K/V for pool storage (int8 mode); identity otherwise."""
    if cfg.kv_dtype != "int8":
        return x
    q = torch.round(x.float() / cfg.kv_scale)
    return torch.clamp(q, -127, 127).to(torch.int8)


def kv_pool_dtype(cfg: ModelConfig, dtype):
    return torch.int8 if cfg.kv_dtype == "int8" else dtype


def _out(p: Dict, o: torch.Tensor, row_parallel: bool = False,
         seq: bool = False) -> torch.Tensor:
    """The output projection of the heads ``o`` (..., H, hd).
    ``row_parallel``: ``wo`` holds only this rank's heads
    (``TPLayout.row_parallel``), and their partial sums are reduced over
    "model" in f32 (``layers.row_parallel_matmul``); ``seq``: the rank
    keeps its slice of the sequence (``TPLayout.seq``), reduce-scattered
    from the partial sums, or cut from a whole output
    (``layers.seq_split``)."""
    H, hd, d = p["wo"].shape
    o, wo = o.reshape(*o.shape[:-2], H * hd), p["wo"].reshape(H * hd, d)
    if row_parallel:
        return layers.row_parallel_matmul(o, wo, seq)
    return layers.seq_split(o @ wo) if seq else o @ wo


def _heads_to_seq(t: torch.Tensor, groups: int = 0) -> torch.Tensor:
    """(B, S, h, D), this rank's h heads of the whole sequence, to (B,
    S/m, m·h, D), every head of its slice of the sequence: the head↔seq
    all-to-all over "model" (``collectives.exchange``, whose backward is
    the same exchange of the cotangent).  The heads come rank-major;
    ``groups`` (the ``"groups"`` cut: a rank's heads are G/m of each of
    the ``groups`` kv groups) puts them back in head order."""
    from repro_torch.distributed.collectives import exchange
    from repro_torch.distributed.sharding import axis_size
    m = axis_size("model")
    B, S, h, D = t.shape
    got = exchange(t.reshape(B, m, S // m, h, D).transpose(0, 1)
                   .contiguous(), ("model",))  # block i: rank i's heads
    out = got.permute(1, 2, 0, 3, 4)  # (B, S/m, m, h, D)
    if groups:  # [rank][group][j] -> [group][rank][j]
        out = out.reshape(B, S // m, m, groups, h // groups, D).transpose(
            2, 3)
    return out.reshape(B, S // m, m * h, D)


def _seq_to_heads(t: torch.Tensor, groups: int = 0) -> torch.Tensor:
    """The inverse of ``_heads_to_seq``: (B, S/m, H, D) to (B, S, H/m,
    D), this rank's heads of the whole sequence."""
    from repro_torch.distributed.collectives import exchange
    from repro_torch.distributed.sharding import axis_size
    m = axis_size("model")
    B, S_l, H, D = t.shape
    if groups:  # [group][rank][j] -> [rank][group][j]
        t = t.reshape(B, S_l, groups, m, H // m // groups, D).transpose(2, 3)
    blocks = t.reshape(B, S_l, m, H // m, D).permute(2, 0, 1, 3, 4)
    got = exchange(blocks.contiguous(), ("model",))  # block i: rank i's slice
    return got.transpose(0, 1).reshape(B, m * S_l, H // m, D)


def _seq_slice(t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of dim 1 of ``t`` (its own part only: under
    autograd the rest of the gradient is zero)."""
    from repro_torch.distributed.sharding import axis_index, axis_size
    w = t.shape[1] // axis_size("model")
    return t.narrow(1, axis_index("model") * w, w)


def _slice_positions(x: torch.Tensor) -> torch.Tensor:
    """(B, S_l) absolute positions of the rank's slice ``x`` (B, S_l, d),
    slice r of the "model" axis: ``r·S_l + i``."""
    from repro_torch.distributed.sharding import axis_index
    B, S_l = x.shape[:2]
    lo = axis_index("model") * S_l
    return (lo + torch.arange(S_l, device=x.device))[None, :].expand(B, S_l)


def _rank_kv(k: torch.Tensor, v: torch.Tensor, n_heads: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Under the ``"q_heads"`` cut: the kv heads (dim -2 of k/v, every kv
    head of the model) that this rank's H/m contiguous q heads over
    "model" read, grouped for them — the rank's whole groups when its
    heads hold some, the one group its heads lie in when they nest in
    one, else each q head's own kv head (G 1)."""
    from repro_torch.distributed.sharding import axis_index, axis_size
    m, r = axis_size("model"), axis_index("model")
    G, h = n_heads // k.shape[-2], n_heads // m
    lo = r * h
    if h % G == 0 or G % h == 0:
        n = max(h // G, 1)
        return k.narrow(-2, lo // G, n), v.narrow(-2, lo // G, n)
    idx = torch.arange(lo, lo + h, device=k.device) // G
    return k.index_select(-2, idx), v.index_select(-2, idx)


def attn_train(p: Dict, x: torch.Tensor, cfg: ModelConfig, *,
               window: int = 0, lens: Optional[torch.Tensor] = None,
               causal: bool = True, impl: str = "kernel",
               cut: str = "whole", seq: bool = False,
               ring: bool = False) -> torch.Tensor:
    """Attention over whole sequences with no cache (the training forward
    and the whisper encoder).  x: (B, S, d) → (B, S, d).  ``window > 0``:
    a ``W`` layer's sliding window; ``causal=False`` with no ``lens`` is
    the full mask (the encoder); K4 under ``impl="kernel"``, the chunked
    online softmax under ``impl="chunked"``.

    ``cut``: the layer's entry of ``TPLayout.attn``.  Under ``"heads"``,
    ``"groups"`` and ``"q_heads"`` the weights hold this rank's heads,
    ``wo``'s partial sums are reduced over "model", and under autograd
    the gradient of ``x`` is summed over "model" (Megatron's f); under
    ``"groups"`` and ``"q_heads"`` so is the gradient of the replicated
    ``wk``/``wv``, which feed only this rank's heads (under
    ``"q_heads"`` through the kv heads they read, ``_rank_kv``).

    ``seq`` (``TPLayout.seq``): ``x`` is the rank's slice (B, S/m, d) of
    the sequence, gathered whole before the projections (under a head
    cut the gradient summed back to the slice, in place of Megatron's
    f), and the output is the rank's slice (``_out``).  ``ring``
    (``TPLayout.ring``, under ``seq``; the train plan's heads stay cut,
    as JAX keeps them): the projections run as under ``seq``, then the
    head↔seq all-to-all (``_heads_to_seq``: GSPMD's around JAX's ring)
    gives every head of the rank's slice — kv heads a rank holds whole
    are cut to the slice — ring attention attends there, and the
    all-to-all back feeds ``wo``.  A ``"whole"`` layer projects the
    slice alone at its absolute positions, as ``attn_prefill``'s ring
    does, its weights' gradients summed over "model"."""
    if ring and cut == "whole":
        p = {k: layers.copy_model(w) for k, w in p.items()}
        q, k, v = _qkv(p, x, _slice_positions(x), cfg.rope_theta)
        return _out(p, core_attn.prefill_attention(
            q, k, v, window=window, lens=lens, causal=causal, impl="ring"))
    if seq:
        x = layers.seq_gather(x, summed=cut != "whole")
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cut != "whole" and not seq:
        x = layers.copy_model(x)
    if cut in ("groups", "q_heads"):
        p = dict(p, wk=layers.copy_model(p["wk"]),
                 wv=layers.copy_model(p["wv"]))
    q, k, v = _qkv(p, x, pos, cfg.rope_theta)
    if ring:
        groups = cfg.n_kv_heads if cut == "groups" else 0
        q = _heads_to_seq(q, groups)
        k, v = ((_heads_to_seq(t) for t in (k, v)) if cut == "heads"
                else (_seq_slice(t) for t in (k, v)))
        o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                        causal=causal, impl="ring")
        return _out(p, _seq_to_heads(o, groups), row_parallel=True,
                    seq=True)
    if cut == "q_heads":
        k, v = _rank_kv(k, v, cfg.n_heads)
    o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                    causal=causal, impl=impl)
    return _out(p, o, row_parallel=cut != "whole", seq=seq)


def attn_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                 tables: torch.Tensor, lens: torch.Tensor, *,
                 window: int = 0, impl: str = "kernel",
                 cut: str = "whole", seq: bool = False,
                 ring: bool = False) -> torch.Tensor:
    """Prefill: attend over the prompt AND write K/V into the paged pools
    (in place).  ``tables``: (B, n_kv_shards, pages_per_shard).  ``cut``:
    the layer's entry of ``TPLayout.attn`` (``attn_train``); under
    ``"q_heads"`` every kv head of the rows goes into the pools (the
    decode layout) and the rank's heads attend over the ones they
    read.  ``seq``: ``x`` is the rank's slice of the sequence, gathered
    whole first; the output is the rank's slice (``_out``).  ``ring``:
    the weights are whole (the ring prefill's layout) and q/k/v of the
    slice, at its absolute positions, go through ring attention; the K/V
    are gathered over the sequence (``Hkv·D`` a token) and the pools get
    what the rank's decode layout holds — the pools' kv heads, the
    rank's share under tp (the prefill writes every page; kvp's stripes
    are ``shard_decode_state``'s)."""
    B = x.shape[0]
    if ring:
        from repro_torch.distributed.collectives import all_gather_dim
        from repro_torch.distributed.sharding import axis_index
        q, k, v = _qkv(p, x, _slice_positions(x), cfg.rope_theta)
        n = k_pages.shape[2]
        lo = axis_index("model") * n if n < k.shape[2] else 0
        kw, vw = (all_gather_dim(t, ("model",), 1).narrow(2, lo, n)
                  for t in (k, v))
        kvcache.write_layer_prefill(k_pages, v_pages, tables.reshape(B, -1),
                                    kv_quant(cfg, kw), kv_quant(cfg, vw),
                                    lens, window=window)
        del kw, vw
        o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                        impl="ring")
        return _out(p, o)
    if seq:
        x = layers.seq_gather(x)
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(p, x, pos, cfg.rope_theta)
    kvcache.write_layer_prefill(k_pages, v_pages, tables.reshape(B, -1),
                                kv_quant(cfg, k), kv_quant(cfg, v), lens,
                                window=window)
    if cut == "q_heads":
        k, v = _rank_kv(k, v, cfg.n_heads)
    o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                    impl=impl)
    return _out(p, o, cut != "whole", seq)


def attn_prefill_contiguous(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                            k_buf: torch.Tensor, v_buf: torch.Tensor,
                            slots: torch.Tensor, lens: torch.Tensor, *,
                            window: int = 0, impl: str = "kernel"
                            ) -> torch.Tensor:
    """Prefill into the contiguous baseline: attend over the prompt as
    `attn_prefill` does (K4 under ``impl="kernel"``) and store its K/V at
    positions 0..S-1 of buffer rows ``slots`` (B,), in place.  k_buf/v_buf:
    (max_slots, Hkv, max_len, hd).  Windowed layers store every position
    too: the buffer has no ring, and decode masks the window."""
    B, S, _ = x.shape
    pos = torch.arange(S, device=x.device)[None, :].expand(B, S)
    q, k, v = _qkv(p, x, pos, cfg.rope_theta)
    kvcache.write_contiguous_prefill(k_buf, v_buf, slots, k, v)
    o = core_attn.prefill_attention(q, k, v, window=window, lens=lens,
                                    impl=impl)
    return _out(p, o)


def attn_prefill_chunked(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                         k_pages: torch.Tensor, v_pages: torch.Tensor,
                         tables: torch.Tensor, q_start: torch.Tensor,
                         q_lens: torch.Tensor, *, window: int = 0,
                         impl: str = "kernel",
                         pages_per_block: Optional[int] = None,
                         num_splits: Optional[int] = None) -> torch.Tensor:
    """Chunked prefill: attend one prompt chunk per sequence, resuming from
    the cached prefix, and write the chunk's K/V into its pages (in place).

    ``x``: (B, C, d) chunk activations; ``q_start``: (B,) tokens already
    cached (RoPE and masks use absolute positions ``q_start + i``);
    ``q_lens``: (B,) live tokens of the chunk; ``tables``: (B,
    n_kv_shards, pages_per_shard).  Dense layers write first, then attend
    over ``kv_lens = q_start + q_lens`` tokens through the block table (K3
    under ``impl="kernel"``).  Sliding-window layers attend first, over
    the intact ring prefix and the chunk's fresh K/V, then write (a ring
    wrap would otherwise overwrite prefix slots the chunk still needs).
    """
    B, C, _ = x.shape
    pos = q_start.long()[:, None] + torch.arange(C, device=x.device)[None]
    q, k, v = _qkv(p, x, pos, cfg.rope_theta)
    t = tables.reshape(B, -1)
    kv_scale = cfg.kv_scale if cfg.kv_dtype == "int8" else 0.0
    if window > 0:
        o = core_attn.prefill_attention_windowed_chunk(
            q, k, v, k_pages, v_pages, t, q_start, q_lens, window=window,
            kv_scale=kv_scale)
        kvcache.write_layer_prefill_at(k_pages, v_pages, t, kv_quant(cfg, k),
                                       kv_quant(cfg, v), q_start, q_lens,
                                       window=window)
        return _out(p, o)
    kvcache.write_layer_prefill_at(k_pages, v_pages, t, kv_quant(cfg, k),
                                   kv_quant(cfg, v), q_start, q_lens)
    o = core_attn.prefill_attention_paged(
        q, k_pages, v_pages, t, (q_start + q_lens).to(torch.int32),
        q_start.to(torch.int32), impl=impl, kv_scale=kv_scale,
        pages_per_block=pages_per_block, num_splits=num_splits)
    return _out(p, o)


def attn_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                k_pages: torch.Tensor, v_pages: torch.Tensor,
                tables: torch.Tensor, positions: torch.Tensor, *,
                window: int = 0, impl: str = "kernel",
                pages_per_block: Optional[int] = None,
                num_splits: Optional[int] = None,
                attn_ctx: Optional[Dict] = None,
                cut: str = "whole") -> torch.Tensor:
    """Decode one token.  x: (B, d); positions: (B,) 0-based position of
    the incoming token; tables: (B, n_kv_shards, pages_per_shard).
    Appends K/V to the pools (in place), then attends over
    lens = positions + 1 tokens.

    ``attn_ctx`` = {"scheme": local|tp|dp|kvp, "batch_axes": (...)}
    selects the distribution scheme under the active mesh
    (``distributed.collectives``); windowed layers decode kvp as dp (ring
    pools are never striped).  The rank's q heads (its slice of ``wq``)
    are grouped over the kv heads its pools hold.  ``cut``: the layer's
    entry of ``TPLayout.attn``; under ``"q_heads"`` (kvp, or dp where the
    model axis divides no group) the rank's heads are gathered over
    "model", every head attends over the rank's pools (its page stripe
    under kvp, merged across the stripes), and the rank keeps its heads'
    output for ``wo`` (GSPMD around JAX's kvp ``shard_map``, whose q
    enters whole).  Under the layout's ``act_embed`` (weight-stationary
    decode) ``x`` and the output are the rank's columns of ``embed``:
    q/k/v from partials summed over those axes (``_qkv``), ``wo`` giving
    the rank's columns."""
    from repro_torch.distributed.collectives import (
        decode_attention_sharded, gather_dim, layer_scheme,
        write_decode_sharded)
    from repro_torch.distributed.sharding import axis_index
    ctx = attn_ctx or {}
    scheme = layer_scheme(ctx.get("scheme", "local"), window)
    batch_axes = tuple(ctx.get("batch_axes", ()))
    ws = ctx["layout"].act_embed if "layout" in ctx else ()
    B = x.shape[0]
    q, k, v = _qkv(p, x, positions, cfg.rope_theta, ws)  # (B, H/Hkv, hd)
    write_decode_sharded(k_pages, v_pages, tables, positions,
                         kv_quant(cfg, k), kv_quant(cfg, v), window=window,
                         scheme=scheme, batch_axes=batch_axes)
    h = q.shape[1]
    if cut == "q_heads":
        q = gather_dim(q, ("model",), 1)
    n_kv = k_pages.shape[2]
    o = decode_attention_sharded(
        q.reshape(B, n_kv, q.shape[1] // n_kv, q.shape[2]), k_pages,
        v_pages, tables, (positions + 1).to(torch.int32), window=window,
        scheme=scheme, batch_axes=batch_axes, impl=impl,
        kv_scale=cfg.kv_scale if cfg.kv_dtype == "int8" else 0.0,
        pages_per_block=pages_per_block, num_splits=num_splits)
    o = o.reshape(q.shape)
    if cut == "q_heads":
        o = o.narrow(1, axis_index("model") * h, h)
    return _out(p, o, cut != "whole")


def attn_decode_contiguous(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                           k_buf: torch.Tensor, v_buf: torch.Tensor,
                           positions: torch.Tensor, *, window: int = 0
                           ) -> torch.Tensor:
    """The paper's baseline decode: store the token's K/V at ``positions``
    in the max-length buffers (in place), then attend over lens =
    positions + 1 tokens of each row.  k_buf/v_buf: (B, Hkv, max_len, hd).
    """
    q, k, v = _qkv(p, x, positions, cfg.rope_theta)
    kvcache.write_contiguous_decode(k_buf, v_buf, positions, k, v)
    o = core_attn.decode_attention_contiguous(q, k_buf, v_buf,
                                              positions + 1, window=window)
    return _out(p, o)


def self_attn_prefill(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                      state: Dict, i: int, lens: torch.Tensor, *,
                      window: int = 0, impl: str = "kernel",
                      cut: str = "whole", seq: bool = False,
                      ring: bool = False) -> torch.Tensor:
    """Prefill attention of attention layer ``i`` of ``state``: into the
    contiguous baseline's buffers (``state["k_buf"]``, rows
    ``state["slots"]``) when the state holds them, else into the paged
    pools through ``state["tables"]`` (``seq``/``ring``: a plan's cut of
    the sequence, ``attn_prefill``)."""
    if "k_buf" in state:
        return attn_prefill_contiguous(
            p, x, cfg, state["k_buf"][i], state["v_buf"][i], state["slots"],
            lens, window=window, impl=impl)
    return attn_prefill(p, x, cfg, state["k_pages"][i], state["v_pages"][i],
                        state["tables"], lens, window=window, impl=impl,
                        cut=cut, seq=seq, ring=ring)


def self_attn_decode(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                     state: Dict, i: int, *, window: int = 0,
                     impl: str = "kernel",
                     pages_per_block: Optional[int] = None,
                     num_splits: Optional[int] = None,
                     attn_ctx: Optional[Dict] = None,
                     cut: str = "whole") -> torch.Tensor:
    """One decode step of attention layer ``i`` of ``state`` at
    ``state["pos"]``: over the contiguous baseline's buffers when the
    state holds them, else over the paged pools."""
    pos = state["pos"]
    if "k_buf" in state:
        return attn_decode_contiguous(p, x, cfg, state["k_buf"][i],
                                      state["v_buf"][i], pos, window=window)
    return attn_decode(p, x, cfg, state["k_pages"][i], state["v_pages"][i],
                       state["tables"], pos, window=window, impl=impl,
                       pages_per_block=pages_per_block,
                       num_splits=num_splits, attn_ctx=attn_ctx, cut=cut)


def cross_kv(p: Dict, ctx: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from the (projected) image context or the
    encoder's output (B, T, d): (B, T, Hkv, hd) each, no positional
    rotation."""
    return _proj(ctx, p["wk"]), _proj(ctx, p["wv"])


def chunk_cross_mode(q_start: torch.Tensor, state: Dict
                     ) -> Tuple[str, Optional[torch.Tensor]]:
    """How a chunk step gets its cross-attention K/V, decided on the host
    from ``q_start == 0`` (as the JAX models decide it): ``"full"`` (every
    row at its first chunk, or no ``cross_k`` in ``state``: project every
    row), ``"partial"`` (project the first-chunk rows, returned, into the
    state's) or ``"reuse"`` (the state's as they are)."""
    firsts = torch.nonzero(q_start.cpu() == 0).flatten()
    if "cross_k" not in state or len(firsts) == len(q_start):
        return "full", None
    if len(firsts):
        return "partial", firsts.to(q_start.device)
    return "reuse", None


def chunk_cross_kv(p: Dict, ctx: Optional[torch.Tensor], state: Dict,
                   i: int, mode: str, rows: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross layer ``i``'s K/V in a chunk step of ``chunk_cross_mode``
    ``mode``: projected from ``ctx`` (every row's, or the ``partial``
    rows' only, which replace those rows of ``state["cross_k"][i]``), or
    the state's."""
    if mode == "full":
        return cross_kv(p, ctx)
    k, v = state["cross_k"][i], state["cross_v"][i]
    if mode == "partial":
        k_new, v_new = cross_kv(p, ctx)
        k = k.index_put((rows,), k_new.to(k.dtype))
        v = v.index_put((rows,), v_new.to(v.dtype))
    return k, v


def cross_attn(p: Dict, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Cross attention: q from x (B, S, d) or (B, d) without RoPE, over
    precomputed k/v (B, T, Hkv, hd), no mask, through the dense plain
    path (the JAX package's ``impl="jnp"``)."""
    q = _proj(x, p["wq"])
    squeeze = x.dim() == 2
    if squeeze:
        q = q[:, None]
    o = core_attn.prefill_attention(q, k, v, causal=False, impl="ref")
    if squeeze:
        o = o[:, 0]
    return _out(p, o)
