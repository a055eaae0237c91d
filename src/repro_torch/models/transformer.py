"""Decoder-only transformer of global (``A``) and sliding-window (``W``)
attention layers and RG-LRU recurrent (``R``) layers: families ``dense``
and ``rglru`` (port of the serving half of ``repro.models.transformer``).

Parameters are plain dicts of tensors with the JAX layouts, one dict per
layer under ``params["layers"]`` (the JAX package stacks them per pattern
group; ``models.convert`` unstacks): an attention layer carries ``attn``,
an ``R`` layer ``rec``.  Three entry points share them:

    prefill       — whole prompts, K/V scattered into the paged pools
    prefill_chunk — one prompt chunk per sequence, resuming from the
                    cached prefix pages (attention layers only)
    decode_step   — one token per sequence against the paged pools

The serving state is a dict: ``pos`` (B,), ``k_pages``/``v_pages``
(n_attn_layers, num_pages, P, Hkv, D), indexed per attention layer, and
``tables`` (B, 1, pages_per_seq); with ``R`` layers also ``rec["R"]``,
``h`` (n_R, B, w) and ``conv`` (n_R, B, cw - 1, w).  The pools and the
recurrent state are updated in place.  ``prefill`` and ``decode_step``
also take the contiguous baseline's state instead of the paged one:
``k_buf``/``v_buf`` (n_attn_layers, max_slots, Hkv, max_len, D), and for
``prefill`` the buffer row of each prompt, ``slots`` (B,).  Every layer
runs through the same loop on either state; prefill attention is K4
either way, decode attention on the buffers the contiguous plain path.

A ``W`` layer attends over the last ``cfg.window`` positions.  On the
paged state it keeps its K/V in a ring of ``ceil(window / P) + 1`` pages:
the first columns of its table row, reused in place, so a model without
``A`` layers needs only ring-wide tables (the engine's
``pages_per_seq``).  On the contiguous state it keeps every position.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.errors import UnsupportedFeature
from repro_torch.models import attention as attn
from repro_torch.models import layers, rglru
from repro_torch.models import spec as pspec

ATTN_CODES = "AW"
CODES = "AWR"  # the layer codes the port runs


def layer_spec(code: str, cfg: ModelConfig) -> Dict:
    out = {"ln1": layers.norm_spec(cfg)}
    if code == "R":
        out["rec"] = rglru.rglru_spec(cfg)
    else:
        out["attn"] = attn.attn_spec(cfg)
    out.update(ln2=layers.norm_spec(cfg), mlp=layers.mlp_spec(cfg))
    return out


class TransformerModel:
    """Global (``A``) or sliding-window (``W``) attention or RG-LRU (``R``)
    per layer, each followed by a gated or plain MLP."""

    def __init__(self, cfg: ModelConfig):
        codes = cfg.pattern()
        if (set(codes) - set(CODES) or cfg.is_moe or cfg.d_ff <= 0
                or cfg.activation not in layers.ACTIVATIONS):
            raise UnsupportedFeature(
                "the port runs 'A', 'W' and 'R' layers with a dense "
                f"{'/'.join(layers.ACTIVATIONS)} MLP; pattern "
                f"{cfg.layer_pattern!r} ('M', 'S' and 'C' layers), "
                f"activation {cfg.activation!r} and MoE are still to be "
                "ported", pattern=cfg.layer_pattern,
                activation=cfg.activation)
        self.cfg = cfg
        self.codes = codes
        self.n_attn_layers = sum(c in ATTN_CODES for c in codes)
        self.n_rec_layers = codes.count("R")
        # windowed iff the pattern has 'W' layers (as the JAX model)
        self.window = cfg.window if "W" in codes else 0
        # per layer: its index among the attention (or the 'R') layers,
        # and its window (mirrors the JAX model's ai counter)
        self.slot = [codes[:li].count("R") if c == "R"
                     else sum(x in ATTN_CODES for x in codes[:li])
                     for li, c in enumerate(codes)]
        self.windows = [cfg.window if c == "W" else 0 for c in codes]

    # -- spec / params ----------------------------------------------------
    def param_spec(self) -> Dict:
        cfg = self.cfg
        return {"embed": layers.embed_spec(cfg),
                "ln_f": layers.norm_spec(cfg),
                "layers": [layer_spec(c, cfg) for c in self.codes]}

    def init_rec_state(self, B: int, dtype=torch.float32, device=None
                       ) -> Optional[Dict]:
        """The recurrent state of ``B`` sequences, zeros: ``{"R": {"h":
        (n_R, B, w), "conv": (n_R, B, cw - 1, w)}}``, or None without
        ``R`` layers."""
        if not self.n_rec_layers:
            return None
        one = rglru.rglru_init_state(B, self.cfg, dtype, device)
        return {"R": {k: v.unsqueeze(0).repeat(
            (self.n_rec_layers,) + (1,) * v.dim()) for k, v in one.items()}}

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Dict:
        return pspec.materialize(self.param_spec(), gen, dtype, device)

    # -- layer application --------------------------------------------------
    def _apply_ffn(self, p: Dict, x: torch.Tensor) -> torch.Tensor:
        return x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x),
                                    self.cfg)

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, params: Dict, tokens: torch.Tensor, state: Dict,
                lens: Optional[torch.Tensor] = None, impl: str = "kernel"
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S) prompts (right-padded).  Returns (last-token
        logits (B, V), state with ``pos = lens``).  ``state["tables"]``
        must already map pages (the engine reserves before calling); the
        pools in ``state`` receive the prompts' K/V in place.  With the
        contiguous state (``k_buf``, ``v_buf``, ``slots``) the prompts'
        K/V land by position in the buffer rows ``slots``.  With ``R``
        layers the returned state holds ``rec``: each row's recurrent
        state after its own last token (``rglru.rglru_prefill``)."""
        cfg = self.cfg
        B, S = tokens.shape
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
        x = layers.embed_tokens(params["embed"], tokens)
        rec = []
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            if self.codes[li] == "R":
                o, final = rglru.rglru_prefill(p["rec"], h, lens, cfg)
                rec.append(final)
            elif "k_buf" in state:
                o = attn.attn_prefill_contiguous(
                    p["attn"], h, cfg, state["k_buf"][self.slot[li]],
                    state["v_buf"][self.slot[li]], state["slots"], lens,
                    window=self.windows[li], impl=impl)
            else:
                ai = self.slot[li]
                o = attn.attn_prefill(
                    p["attn"], h, cfg, state["k_pages"][ai],
                    state["v_pages"][ai], state["tables"], lens,
                    window=self.windows[li], impl=impl)
            x = self._apply_ffn(p, x + o)
        x = layers.apply_norm(params["ln_f"], x)
        last_idx = torch.clamp(lens.long() - 1, min=0)
        last = x[torch.arange(B, device=x.device), last_idx]
        logits = layers.unembed(params["embed"], last, cfg)
        out = dict(state, pos=lens)
        if rec:
            out["rec"] = {"R": {k: torch.stack([r[k] for r in rec])
                                for k in rec[0]}}
        return logits, out

    def prefill_chunk(self, params: Dict, tokens: torch.Tensor,
                      state: Dict, q_start: torch.Tensor,
                      q_lens: torch.Tensor, impl: str = "kernel",
                      pages_per_block: Optional[int] = None,
                      num_splits: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Chunked prefill: one prompt chunk per sequence, resuming from
        the cached prefix.

        ``tokens``: (B, C) chunk tokens (right-padded); ``q_start``: (B,)
        tokens already cached (positions, masks and the K/V scatter use
        absolute ``q_start + i``); ``q_lens``: (B,) live tokens of the
        chunk.  ``state["tables"]`` must already map pages covering
        ``q_start + q_lens`` tokens.  Returns the logits of each row's
        last live token and the state with ``pos = q_start + q_lens``;
        the pools receive the chunk's K/V in place.  ``prefill`` is the
        one-chunk case (``q_start = 0``, ``q_lens = lens``).

        Recurrent (``R``) layers are not chunkable, as in the JAX package:
        their state would have to be carried across chunks.
        """
        cfg = self.cfg
        if self.n_rec_layers:
            raise UnsupportedFeature(
                "chunked prefill does not support recurrent layers "
                f"(pattern {cfg.layer_pattern!r}): carrying recurrent "
                "state across chunks is an open ROADMAP item",
                pattern=cfg.layer_pattern)
        B = tokens.shape[0]
        x = layers.embed_tokens(params["embed"], tokens)
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            x = x + attn.attn_prefill_chunked(
                p["attn"], h, cfg, state["k_pages"][li], state["v_pages"][li],
                state["tables"], q_start, q_lens, window=self.windows[li],
                impl=impl, pages_per_block=pages_per_block,
                num_splits=num_splits)
            x = self._apply_ffn(p, x)
        x = layers.apply_norm(params["ln_f"], x)
        last_idx = torch.clamp(q_lens.long() - 1, min=0)
        last = x[torch.arange(B, device=x.device), last_idx]
        logits = layers.unembed(params["embed"], last, cfg)
        return logits, dict(state, pos=q_start + q_lens)

    def decode_step(self, params: Dict, tokens: torch.Tensor, state: Dict,
                    impl: str = "kernel",
                    pages_per_block: Optional[int] = None,
                    num_splits: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) → (logits (B, V), state with ``pos + 1``).  Each
        attention layer appends its K/V to the pools in place and attends
        over the pages through the block table (with the contiguous state:
        stores its K/V at ``pos`` in ``k_buf``/``v_buf`` and attends over
        the buffers); each ``R`` layer steps its recurrent state in
        ``state["rec"]``, in place."""
        cfg = self.cfg
        pos = state["pos"]
        x = layers.embed_tokens(params["embed"], tokens)
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            if self.codes[li] == "R":
                ri = self.slot[li]
                rec = state["rec"]["R"]
                o, new = rglru.rglru_decode(
                    p["rec"], h, {k: v[ri] for k, v in rec.items()}, cfg)
                for k, v in new.items():
                    rec[k][ri] = v
            elif "k_buf" in state:
                o = attn.attn_decode_contiguous(
                    p["attn"], h, cfg, state["k_buf"][self.slot[li]],
                    state["v_buf"][self.slot[li]], pos,
                    window=self.windows[li])
            else:
                ai = self.slot[li]
                o = attn.attn_decode(
                    p["attn"], h, cfg, state["k_pages"][ai],
                    state["v_pages"][ai], state["tables"], pos,
                    window=self.windows[li], impl=impl,
                    pages_per_block=pages_per_block, num_splits=num_splits)
            x = self._apply_ffn(p, x + o)
        x = layers.apply_norm(params["ln_f"], x)
        logits = layers.unembed(params["embed"], x, cfg)
        return logits, dict(state, pos=pos + 1)
