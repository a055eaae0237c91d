"""Decoder-only transformer of global (``A``) and sliding-window (``W``)
attention layers, recurrent layers (RG-LRU ``R``, mLSTM ``M``, sLSTM
``S``) and cross-attention (``C``) layers, each followed by a dense or MoE
FFN, or by none when ``d_ff == 0`` (xLSTM): families ``dense``, ``moe``,
``vlm``, ``rglru`` and ``xlstm`` (port of
``repro.models.transformer``).

Parameters are plain dicts of tensors with the JAX layouts, one dict per
layer under ``params["layers"]`` (the JAX package stacks them per pattern
group; ``models.convert`` unstacks): an attention layer carries ``attn``,
a ``C`` layer ``attn`` and a scalar ``gate``, an ``R``, ``M`` or ``S``
layer ``rec``; the FFN is ``mlp`` or ``moe`` (``models.moe``), or none.
A ``vlm`` model also has ``vision_proj`` (d_vision, d_model), which
projects the per-request image embeddings (``extra["image_embeds"]``,
(B, n_image_tokens, d_vision)) into the cross-attention context.  Five
entry points share them:

    forward       — teacher-forced whole sequences (training), with the
                    MoE aux loss returned beside the logits
    loss_fn       — cross entropy + router_aux_coef · aux over a batch
    prefill       — whole prompts, K/V scattered into the paged pools
    prefill_chunk — one prompt chunk per sequence, resuming from
                    the cached prefix pages (no recurrent layers)
    decode_step   — one token per sequence against the paged pools

The serving state is a dict: ``pos`` (B,), ``k_pages``/``v_pages``
(n_attn_layers, num_pages, P, Hkv, D), indexed per attention layer, and
``tables`` (B, 1, pages_per_seq); with recurrent layers also ``rec``,
one dict per code: ``rec["R"]`` with ``h`` (n_R, B, w) and ``conv`` (n_R,
B, cw - 1, w), ``rec["M"]`` with ``C`` (n_M, B, H, dh, dh), ``n`` and
``m``, ``rec["S"]`` with ``c``, ``n``, ``h`` and ``m`` (n_S, B, H, dh)
(``models.ssm``); with ``C`` layers
``cross_k``/``cross_v`` (n_cross, B, n_image_tokens, Hkv, D), which
``prefill`` and ``prefill_chunk`` return for the rows they project and
``decode_step`` reads.  The pools and the recurrent state are updated in
place.  ``prefill`` and ``decode_step`` also take the contiguous
baseline's state instead of the paged one: ``k_buf``/``v_buf``
(n_attn_layers, max_slots, Hkv, max_len, D), and for ``prefill`` the
buffer row of each prompt, ``slots`` (B,).  Every layer runs through the
same loop on either state; prefill attention is K4 either way, decode
attention on the buffers the contiguous plain path.  Cross-attention runs
the dense plain path everywhere, as in the JAX package.  A recurrent
layer's prefill returns each row's state after its own last token
(``lens - 1``), not at the padded end as the JAX package does.

A ``W`` layer attends over the last ``cfg.window`` positions.  On the
paged state it keeps its K/V in a ring of ``ceil(window / P) + 1`` pages:
the first columns of its table row, reused in place, so a model without
``A`` layers needs only ring-wide tables (the engine's
``pages_per_seq``).  On the contiguous state it keeps every position.

MoE layers route only the live tokens (``models.moe``): prefill's ``pos <
lens``, a chunk's ``i < q_lens``, and in decode the rows the caller marks
``live``; ``n_live``, their count, comes from the caller's host (read
from the device when it is not given).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import TRAIN_IMPLS
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (P, TPLayout, current_mesh,
                                              current_rules, shard_params,
                                              shard_tensor, use_mesh)
from repro_torch.errors import InvalidRequest, UnsupportedFeature
from repro_torch.kernels import check_impl
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, ssm
from repro_torch.models import spec as pspec
from repro_torch.models.spec import ParamSpec
from repro_torch.utils.fake import count_true

ATTN_CODES = "AW"
REC_CODES = "RMS"
CODES = "AWRCMS"  # the layer codes the port runs
# each recurrent code's block: its parameters, its zero state, its
# prefill (with the state at each row's last token) and one decode step;
# the steps are looked up in their module at each call, so a wrapper set
# there (a profiler range) takes effect
REC_SPEC = {"R": rglru.rglru_spec, "M": ssm.mlstm_spec, "S": ssm.slstm_spec}
REC_INIT = {"R": rglru.rglru_init_state, "M": ssm.mlstm_init_state,
            "S": ssm.slstm_init_state}
# (the R block also takes a layout's switches as keywords, ``_rec_kw``)
REC_PREFILL = {"R": lambda *a, **k: rglru.rglru_prefill(*a, **k),
               "M": lambda *a: ssm.mlstm_prefill(*a),
               "S": lambda *a: ssm.slstm_prefill(*a)}
REC_DECODE = {"R": lambda *a, **k: rglru.rglru_decode(*a, **k),
              "M": lambda *a: ssm.mlstm_decode(*a),
              "S": lambda *a: ssm.slstm_decode(*a)}
REC_TRAIN = {"R": lambda *a, **k: rglru.rglru_train(*a, **k),
             "M": lambda *a: ssm.mlstm_train(*a),
             "S": lambda *a: ssm.slstm_train(*a)}
# the layer codes the distributed steps take
DIST_CODES = "AWR"


def _ffn_spec(cfg: ModelConfig) -> Dict:
    if cfg.is_moe:
        return {"ln2": layers.norm_spec(cfg), "moe": moe.moe_spec(cfg)}
    if cfg.d_ff > 0:
        return {"ln2": layers.norm_spec(cfg), "mlp": layers.mlp_spec(cfg)}
    return {}


def layer_spec(code: str, cfg: ModelConfig) -> Dict:
    out = {"ln1": layers.norm_spec(cfg)}
    if code in REC_CODES:
        out["rec"] = REC_SPEC[code](cfg)
    else:
        out["attn"] = attn.attn_spec(cfg)
    if code == "C":
        out["gate"] = ParamSpec((), (), "zeros")
    out.update(_ffn_spec(cfg))
    return out


class TransformerModel:
    """Global (``A``) or sliding-window (``W``) attention, RG-LRU (``R``),
    mLSTM (``M``), sLSTM (``S``) or cross-attention (``C``) per layer,
    each followed by a gated or plain MLP, an MoE FFN or no FFN.

    What a request carries beside its prompt, for the engine: the key of
    its per-request context (``extra_key``, None without ``C`` layers),
    that context's shape (``extra_shape``) and the length of the
    cross-attention K/V it projects to (``cross_len``)."""

    def __init__(self, cfg: ModelConfig):
        codes = cfg.pattern()
        mlp = not cfg.is_moe and cfg.d_ff > 0
        if set(codes) - set(CODES) or (
                mlp and cfg.activation not in layers.ACTIVATIONS):
            raise UnsupportedFeature(
                f"the port runs the layer codes {CODES!r} with a dense "
                f"{'/'.join(layers.ACTIVATIONS)} MLP, an MoE FFN or none; "
                f"pattern {cfg.layer_pattern!r} and activation "
                f"{cfg.activation!r} are not ported",
                pattern=cfg.layer_pattern, activation=cfg.activation)
        self.cfg = cfg
        self.codes = codes
        self.n_attn_layers = sum(c in ATTN_CODES for c in codes)
        self.n_rec_layers = sum(c in REC_CODES for c in codes)
        self.n_cross_layers = codes.count("C")
        self.extra_key = "image_embeds" if self.n_cross_layers else None
        self.extra_shape = (cfg.n_image_tokens, cfg.d_vision)
        self.cross_len = cfg.n_image_tokens
        # windowed iff the pattern has 'W' layers (as the JAX model)
        self.window = cfg.window if "W" in codes else 0
        # per layer: its index among the layers of its kind (attention, or
        # its own code for 'R', 'M', 'S' and 'C'), and its window (the JAX
        # model's ai/ci counters)
        self.slot = [codes[:li].count(c) if c in "RMSC"
                     else sum(x in ATTN_CODES for x in codes[:li])
                     for li, c in enumerate(codes)]
        self.windows = [cfg.window if c == "W" else 0 for c in codes]

    # -- spec / params ----------------------------------------------------
    def param_spec(self) -> Dict:
        cfg = self.cfg
        out = {"embed": layers.embed_spec(cfg),
               "ln_f": layers.norm_spec(cfg),
               "layers": [layer_spec(c, cfg) for c in self.codes]}
        if cfg.family == "vlm":
            out["vision_proj"] = ParamSpec((cfg.d_vision, cfg.d_model),
                                           (None, "embed"))
        return out

    def init_rec_state(self, B: int, dtype=torch.float32, device=None,
                       plan=None) -> Optional[Dict]:
        """The recurrent state of ``B`` sequences, the blocks' zero states
        stacked per code: ``{"R": {"h": (n_R, B, w), "conv": (n_R, B, cw
        - 1, w)}, "M": {...}, "S": {...}}`` for the codes the pattern
        has, or None without recurrent layers.  With a ``plan`` the
        rank's share of the ``R`` channels, ``w/m`` under
        ``plan.layout.state`` (the rows are the caller's ``B``)."""
        out = {}
        for code in REC_CODES:
            n = self.codes.count(code)
            if n:
                kw = {}
                if code == "R" and plan is not None and plan.layout.state:
                    kw["parts"] = plan.mesh.size("model")
                one = REC_INIT[code](B, self.cfg, dtype, device, **kw)
                out[code] = {k: v.unsqueeze(0).repeat((n,) + (1,) * v.dim())
                             for k, v in one.items()}
        return out or None

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None, plan=None) -> Dict:
        """Draw the parameters from ``gen``.  With a ``plan``
        (``launch.steps.Plan``) keep only this rank's pieces
        (``shard_params``): each top-level entry and each layer is drawn
        whole, in the order of the unsharded draw, and cut at once, so
        every rank draws the same weights and holds one full layer at a
        time."""
        spec = self.param_spec()
        if plan is None:
            return pspec.materialize(spec, gen, dtype, device)
        self._check_distributable()
        out = {}
        for key in sorted(spec):
            if key == "layers":
                out[key] = [self._shard_layer(
                    li, pspec.materialize(ls, gen, dtype, device), plan)
                    for li, ls in enumerate(spec[key])]
            else:
                out[key] = shard_params(
                    pspec.materialize(spec[key], gen, dtype, device),
                    spec[key], plan.mesh, plan.layout.rules())
        return out

    # -- tensor parallelism -------------------------------------------------
    def shard_params(self, params: Dict, plan) -> Dict:
        """This rank's pieces of full ``params`` under ``plan`` (Megatron
        style and FSDP; the JAX package leaves the layout to GSPMD), cut
        as ``plan.layout`` (``distributed.sharding.TPLayout``) says:

          * ``embed``: the vocab over "model" when it divides, else whole;
          * attention, per layer: ``"heads"`` — ``wq``/``wk``/``wv`` by
            heads (q and kv), ``wo`` by the same heads; ``"groups"`` — the
            kv projections whole, ``wq``/``wo`` by G/m heads of every
            group; ``"q_heads"`` — ``wq``/``wo`` by H/m contiguous heads,
            the kv projections whole; ``"whole"``;
          * MLP: ``wg``/``wu`` by columns of ``d_ff``, ``wd`` by rows;
          * RG-LRU (``R``): the ``w`` channels over "model" where it
            divides them (``TPLayout.state``): ``wx``/``wy``/``conv``/
            ``conv_b``/``a_log`` by columns, ``wa``/``wi``/``wout`` by
            rows;
          * MoE: the experts over "model" (E/m a rank, GSPMD's cut or
            ``moe_ep``'s all-to-all: ``TPLayout.moe``), the router whole;
          * every weight's ``embed`` dim over ``layout.fsdp`` (FSDP, the
            configs' ``embed: ("data",)`` override) where it divides it,
            norms included; the model gathers each such piece just before
            it uses it (``layers.gather_fsdp``)."""
        self._check_distributable()
        spec = self.param_spec()
        return {k: [self._shard_layer(li, p, plan)
                    for li, p in enumerate(v)] if k == "layers"
                else shard_params(v, spec[k], plan.mesh, plan.layout.rules())
                for k, v in params.items()}

    def _check_distributable(self):
        if set(self.codes) - set(DIST_CODES):
            raise UnsupportedFeature(
                "the distributed steps take models of 'A', 'W' and 'R' "
                f"layers; pattern {self.cfg.layer_pattern!r}",
                pattern=self.cfg.layer_pattern)

    @staticmethod
    def _rec_kw(code: str, lay: TPLayout, decode: bool = False) -> Dict:
        """The layout's switches of an ``R`` block (its channels over
        "model", and the sequence cut or, in decode, the columns of
        ``embed``); none for the other recurrent blocks."""
        if code != "R":
            return {}
        if decode:
            return {"cut": lay.state, "ws": lay.act_embed}
        return {"cut": lay.state, "seq": lay.seq}

    def _shard_layer(self, li: int, p: Dict, plan) -> Dict:
        mesh, lay = plan.mesh, plan.layout
        spec = layer_spec(self.codes[li], self.cfg)
        rest = {k: v for k, v in p.items() if k != "attn"}
        out = shard_params(rest, {k: v for k, v in spec.items()
                                  if k != "attn"}, mesh, lay.rules())
        if "attn" not in p:  # a recurrent layer: cut by lay.rules()
            return out
        if lay.attn[li] != "groups":
            out["attn"] = shard_params(p["attn"], spec["attn"], mesh,
                                       lay.attn_rules(li))
            return out
        # the strided cut: G/m heads of every kv group (the FSDP cut of
        # the embed dims first, which the head cut does not touch)
        a = shard_params(p["attn"], spec["attn"], mesh, lay.rules())
        d, H, hd = a["wq"].shape
        Hkv = self.cfg.n_kv_heads
        G, m = H // Hkv, mesh.size("model")
        wq = shard_tensor(a["wq"].reshape(d, Hkv, G, hd),
                          P(None, None, "model"), mesh)
        e = a["wo"].shape[-1]
        wo = shard_tensor(a["wo"].reshape(Hkv, G, hd, e), P(None, "model"),
                          mesh)
        out["attn"] = {"wq": wq.reshape(d, H // m, hd), "wk": a["wk"],
                       "wv": a["wv"], "wo": wo.reshape(H // m, hd, e)}
        return out

    def _gather_layer(self, li: int, p: Dict, lay: TPLayout,
                      batch_axes: Tuple[str, ...] = ()) -> Dict:
        """Layer ``li``'s weights whole where ``lay.fsdp`` cuts them,
        gathered just before use (``layers.gather_fsdp``); under
        ``lay.act_embed`` (weight-stationary decode) the rank's slices
        of their ``embed`` dims instead, never gathered
        (``layers.ws_pieces``)."""
        spec = layer_spec(self.codes[li], self.cfg)
        if lay.act_embed:
            return layers.ws_pieces(p, spec, lay)
        if not lay.fsdp:
            return p
        return layers.gather_fsdp(p, spec, lay, batch_axes)

    def _gather_top(self, params: Dict, key: str, lay: TPLayout,
                    batch_axes: Tuple[str, ...] = ()) -> Dict:
        """``params[key]`` (``"embed"``, ``"ln_f"``), gathered (or under
        ``lay.act_embed`` sliced) alike."""
        spec = {"embed": layers.embed_spec, "ln_f": layers.norm_spec}[key]
        if lay.act_embed:
            return layers.ws_pieces(params[key], spec(self.cfg), lay)
        if not lay.fsdp:
            return params[key]
        return layers.gather_fsdp(params[key], spec(self.cfg), lay,
                                  batch_axes)

    def init_decode_state(self, run, dtype=torch.float32, device="cuda",
                          plan=None) -> Dict:
        """The serving state of ``run`` (the JAX ``init_decode_state`` on
        one stripe), zeros: ``pos`` (B,), pools (n_attn_layers,
        B·pages_per_seq, P, Hkv, D) and ``tables`` (B, 1, pages_per_seq),
        ``pages_per_seq`` the ring under ``W`` layers, and with ``R``
        layers their zero state ``rec`` (``init_rec_state``: the JAX
        function's ``rec``).  With a ``plan`` the pools hold the rank's
        kv heads (``plan.layout.kv_heads``), as its prefill under the
        plan writes them, and ``rec`` the rank's channels; kvp's striped
        tables come from ``distributed.collectives.shard_decode_state``
        after the prefill.  Models of ``A``, ``W`` and ``R`` layers
        only."""
        cfg = self.cfg
        self._check_distributable()
        device = resolve_device(device)
        B, ps = run.global_batch, cfg.page_size
        pps = (-(-self.window // ps) + 1 if self.window > 0
               else run.pages_per_seq)
        Hkv = plan.layout.kv_heads if plan is not None else cfg.n_kv_heads
        pool = (self.n_attn_layers, B * pps, ps, Hkv, cfg.resolved_head_dim)
        pool_dt = attn.kv_pool_dtype(cfg, dtype)
        out = {"pos": torch.zeros((B,), dtype=torch.int32, device=device),
               "k_pages": torch.zeros(pool, dtype=pool_dt, device=device),
               "v_pages": torch.zeros(pool, dtype=pool_dt, device=device),
               "tables": torch.zeros((B, 1, pps), dtype=torch.int32,
                                     device=device)}
        if self.n_rec_layers:
            out["rec"] = self.init_rec_state(B, dtype, device, plan)
        return out

    # -- layer application --------------------------------------------------
    @staticmethod
    def _norm(p: Dict, x: torch.Tensor, lay: TPLayout) -> torch.Tensor:
        """``layers.apply_norm``; under ``lay.seq`` it runs on the rank's
        slice of the sequence, so its weights' gradient is summed over
        "model" (``layers.copy_model``); under ``lay.act_embed`` on the
        rank's columns, its sums all-reduced over those axes."""
        if lay.seq:
            p = {k: layers.copy_model(v) for k, v in p.items()}
        return layers.apply_norm(p, x, axes=lay.act_embed)

    def _moe_ep(self, p: Dict, h: torch.Tensor, lay: TPLayout,
                live: Optional[torch.Tensor] = None,
                n_live: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``ep.apply_moe_ep`` of ``h``; under ``lay.seq`` (``h`` the
        rank's slice) over the whole sequence, gathered (JAX's
        ``in_specs`` take ``x`` whole over "model"), the rank keeping its
        slice of the output (``layers.seq_split``): every rank then holds
        the whole tokens and, in the backward, the whole cotangent, as
        the function's gradient law has them."""
        from repro_torch.distributed import ep
        if not lay.seq:
            return ep.apply_moe_ep(p, h, self.cfg, live=live, n_live=n_live,
                                   ws=lay.act_embed)
        o, aux = ep.apply_moe_ep(p, layers.seq_gather(h, summed=False),
                                 self.cfg, live=live, n_live=n_live)
        return layers.seq_split(o), aux

    def _apply_ffn(self, p: Dict, x: torch.Tensor,
                   live: Optional[torch.Tensor] = None,
                   n_live: Optional[int] = None,
                   layout: TPLayout = TPLayout()) -> torch.Tensor:
        """The layer's FFN; ``layout``: the rank's cut of its weights (the
        experts over "model": GSPMD's cut in ``moe.apply_moe``, or
        ``ep.apply_moe_ep`` under ``moe_ep``), of the sequence
        (``layout.seq``: ``x`` is the rank's slice) and of ``embed``
        (``layout.act_embed``: ``x`` is the rank's columns)."""
        if "ln2" not in p:  # no FFN (d_ff == 0)
            return x
        h = self._norm(p["ln2"], x, layout)
        ws = layout.act_embed
        if "moe" in p:
            if layout.ep:
                return x + self._moe_ep(p["moe"], h, layout, live, n_live)[0]
            return x + moe.apply_moe(p["moe"], h, self.cfg, live=live,
                                     n_live=n_live, cut=layout.experts,
                                     seq=layout.seq, ws=ws)
        return x + layers.apply_mlp(p["mlp"], h, self.cfg, layout.mlp,
                                    layout.seq, ws)

    def _live_tokens(self, lens: torch.Tensor, width: int,
                     n_live: Optional[int]
                     ) -> Tuple[Optional[torch.Tensor], Optional[int]]:
        """The tokens the MoE FFN routes, ``i < lens`` over (B, width),
        and their count (read on the host unless given); (None, None)
        for a dense FFN."""
        if not self.cfg.is_moe:
            return None, None
        live = torch.arange(width, device=lens.device)[None] < lens[:, None]
        return live, count_true(live) if n_live is None else n_live

    def project_extra(self, params: Dict, extra: Optional[Dict]
                      ) -> Optional[torch.Tensor]:
        """The cross-attention context (B, n_image_tokens, d_model):
        ``extra["image_embeds"] @ vision_proj`` (as given, without
        ``vision_proj``), or None without ``C`` layers."""
        if not self.n_cross_layers:
            return None
        if not extra or "image_embeds" not in extra:
            raise InvalidRequest(
                "cross-attention layers need extra['image_embeds'] of "
                f"shape (B, {self.cfg.n_image_tokens}, {self.cfg.d_vision})")
        img, w = extra["image_embeds"], params.get("vision_proj")
        return img if w is None else img.to(w.dtype) @ w

    def _cross(self, p: Dict, h: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> torch.Tensor:
        return torch.tanh(p["gate"]) * attn.cross_attn(p["attn"], h, k, v,
                                                       self.cfg)

    # -- forward (training) -------------------------------------------------
    def _train_layer(self, li: int, p: Dict, x: torch.Tensor,
                     img: Optional[torch.Tensor], impl: str,
                     lay: TPLayout = TPLayout(),
                     batch_axes: Tuple[str, ...] = ()
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer over whole sequences: (x', the MoE aux loss or
        None).  ``lay``: the rank's cut of the weights; ``batch_axes``:
        the mesh axes the rows are spread over (the aux loss is the whole
        batch's, or under ``moe_ep`` JAX's EP law: each shard's own,
        averaged).  An MoE layer runs as ``lay.moe()`` says: the experts
        whole or cut (``moe.apply_moe_train``), or exchanged by
        all-to-all (``ep.apply_moe_ep``)."""
        cfg = self.cfg
        code = self.codes[li]
        p = self._gather_layer(li, p, lay, batch_axes)
        h = self._norm(p["ln1"], x, lay)
        if code in ATTN_CODES:
            x = x + attn.attn_train(p["attn"], h, cfg,
                                    window=self.windows[li], impl=impl,
                                    cut=lay.cut(li), seq=lay.seq,
                                    ring=lay.ring)
        elif code == "C":
            x = x + self._cross(p, h, *attn.cross_kv(p["attn"], img))
        else:
            x = x + REC_TRAIN[code](p["rec"], h, cfg,
                                    **self._rec_kw(code, lay))
        if "moe" in p:
            h = self._norm(p["ln2"], x, lay)
            if lay.ep:
                o, aux = self._moe_ep(p["moe"], h, lay)
            else:
                o, aux = moe.apply_moe_train(p["moe"], h, cfg, batch_axes,
                                             cut=lay.experts, seq=lay.seq)
            return x + o, aux
        return self._apply_ffn(p, x, layout=lay), None

    def _train_ctx(self, attn_ctx: Optional[Dict]
                   ) -> Tuple[TPLayout, Tuple[str, ...]]:
        """The layout and batch axes of a train plan's ``attn_ctx``
        (``launch.steps.Plan.attn_ctx``); refuses what the port does not
        train across ranks: layers other than ``A``/``W``/``R``
        (``_layout_of``)."""
        return (self._layout_of(attn_ctx),
                tuple((attn_ctx or {}).get("batch_axes", ())))

    def forward(self, params: Dict, tokens: torch.Tensor,
                extra: Optional[Dict] = None, impl: str = "ref",
                attn_ctx: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced forward over whole sequences, the training path.
        tokens: (B, S) → (logits (B, S, V), the MoE load-balance loss summed
        over the layers, an f32 scalar: 0 without MoE layers).

        ``impl``: "ref" (dense attention in plain ops), "chunked" (the
        tiled online softmax) or "kernel" (K4, forward only: under
        autograd it raises ``UnsupportedFeature``).  The layers run in
        pattern units, as the JAX package scans them; with ``cfg.remat !=
        "none"`` each whole unit is recomputed in the backward
        (``torch.utils.checkpoint``), as JAX checkpoints its unit body,
        and the trailing layers past the last whole unit are not.

        ``attn_ctx``: a train plan's (``launch.steps.Plan.attn_ctx``) under
        its mesh: ``params`` are this rank's pieces (``layout``: heads,
        ``d_ff`` columns and the vocab over "model", Megatron style, the
        experts over "model" too, the activations between blocks the
        rank's slice (B, S/m, d) of the sequence under ``layout.seq`` —
        a checkpointed unit saves the slice — and whole otherwise, ring
        attention on the slices under ``layout.ring``; the logits of
        every token on each rank; ``embed`` dims over the FSDP
        axes, each layer's gathered just before it runs and, under
        ``remat``, again in the backward; an ``R`` block's channels over
        "model" under ``layout.state``) and ``tokens`` its rows of a
        batch over ``batch_axes``.  Models of ``A``, ``W`` and ``R``
        layers."""
        check_impl(impl, TRAIN_IMPLS, "forward")
        cfg = self.cfg
        lay, batch_axes = self._train_ctx(attn_ctx)
        img = self.project_extra(params, extra)
        x = layers.embed_tokens(
            self._gather_top(params, "embed", lay, batch_axes), tokens,
            lay.vocab, lay.seq)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        # a recomputed unit runs on the backward's thread: it re-enters
        # the mesh its forward ran under
        mesh, rules = current_mesh(), current_rules()

        def run(lo, hi, x, aux):
            with use_mesh(mesh, rules):
                for li in range(lo, hi):
                    x, a = self._train_layer(li, params["layers"][li], x,
                                             img, impl, lay, batch_axes)
                    if a is not None:
                        aux = aux + a
            return x, aux

        unit = len(cfg.layer_pattern)
        n_grouped = len(self.codes) // unit * unit
        for lo in range(0, n_grouped, unit):
            if cfg.remat != "none":
                x, aux = torch.utils.checkpoint.checkpoint(
                    run, lo, lo + unit, x, aux, use_reentrant=False)
            else:
                x, aux = run(lo, lo + unit, x, aux)
        x, aux = run(n_grouped, len(self.codes), x, aux)
        x = self._norm(self._gather_top(params, "ln_f", lay, batch_axes), x,
                       lay)
        return layers.unembed(
            self._gather_top(params, "embed", lay, batch_axes), x, cfg,
            lay.vocab, lay.seq), aux

    def loss_fn(self, params: Dict, batch: Dict, impl: str = "ref",
                attn_ctx: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"inputs": (B, S), "targets": (B, S), "mask"?, extras
        ("image_embeds")} → (ce + router_aux_coef · aux, {"ce", "aux"}).
        ``attn_ctx``: a train plan's (``forward``); over its batch axes
        ``ce`` is this rank's part of the global mean (``layers.xent``:
        the parts add up over the ranks) and ``aux`` the whole batch's
        (under ``moe_ep`` the mean of each shard's, JAX's EP law)."""
        extra = {k: v for k, v in batch.items()
                 if k not in ("inputs", "targets", "mask")}
        logits, aux = self.forward(params, batch["inputs"], extra or None,
                                   impl, attn_ctx)
        ce = layers.xent(logits, batch["targets"], batch.get("mask"),
                         tuple((attn_ctx or {}).get("batch_axes", ())))
        return ce + self.cfg.router_aux_coef * aux, {"ce": ce, "aux": aux}

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, params: Dict, tokens: torch.Tensor, state: Dict,
                lens: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None, impl: str = "kernel",
                n_live: Optional[int] = None,
                attn_ctx: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S) prompts (right-padded).  Returns (last-token
        logits (B, V), state with ``pos = lens``).  ``state["tables"]``
        must already map pages (the engine reserves before calling); the
        pools in ``state`` receive the prompts' K/V in place.  With the
        contiguous state (``k_buf``, ``v_buf``, ``slots``) the prompts'
        K/V land by position in the buffer rows ``slots``.  With recurrent
        layers the returned state holds ``rec``: each row's recurrent
        state after its own last token (``rglru.rglru_prefill``,
        ``ssm.mlstm_prefill``, ``ssm.slstm_prefill``); with
        ``C`` layers ``cross_k``/``cross_v`` of the rows' image context
        (``extra``).  ``n_live``: the live tokens, ``sum(lens)``.
        ``attn_ctx``: the plan's (``launch.steps.Plan.attn_ctx``); its
        ``layout`` says which weights are this rank's pieces, and each
        rank prefills with the heads it holds into its own pools (every
        kv head under dp and kvp, whose decode layout
        ``shard_decode_state`` then cuts); under ``layout.seq`` each
        rank holds its slice of the sequence between blocks (attention
        over the gathered sequence, K4 unless ``impl="ref"``), under
        ``layout.ring`` ring attention on the slices (plain ops), an
        ``R`` block on the rank's channels under ``layout.state`` (its
        state too), and the last token's logits come from the rank that
        holds it.  Models of ``A``, ``W`` and ``R`` layers under a mesh."""
        check_impl(impl, entry="prefill")
        cfg = self.cfg
        B, S = tokens.shape
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
        live, n_live = self._live_tokens(lens, S, n_live)
        img = self.project_extra(params, extra)
        lay = self._layout_of(attn_ctx)
        x = layers.embed_tokens(self._gather_top(params, "embed", lay),
                                tokens, lay.vocab, lay.seq)
        rec, cross = {}, []
        for li, p in enumerate(params["layers"]):
            p = self._gather_layer(li, p, lay)
            h = self._norm(p["ln1"], x, lay)
            code = self.codes[li]
            if code in REC_CODES:
                o, final = REC_PREFILL[code](p["rec"], h, lens, cfg,
                                             **self._rec_kw(code, lay))
                rec.setdefault(code, []).append(final)
            elif code == "C":
                k, v = attn.cross_kv(p["attn"], img)
                cross.append((k, v))
                o = self._cross(p, h, k, v)
            else:
                o = attn.self_attn_prefill(
                    p["attn"], h, cfg, state, self.slot[li], lens,
                    window=self.windows[li], impl=impl, cut=lay.cut(li),
                    seq=lay.seq, ring=lay.ring)
            x = self._apply_ffn(p, x + o, live, n_live, lay)
        x = self._norm(self._gather_top(params, "ln_f", lay), x, lay)
        logits = layers.unembed(self._gather_top(params, "embed", lay),
                                self._last(x, lens, lay), cfg, lay.vocab)
        out = dict(state, pos=lens)
        if rec:
            out["rec"] = {code: {k: torch.stack([r[k] for r in finals])
                                 for k in finals[0]}
                          for code, finals in rec.items()}
        if cross:
            out["cross_k"] = torch.stack([k for k, _ in cross])
            out["cross_v"] = torch.stack([v for _, v in cross])
        return logits, out

    def _layout_of(self, attn_ctx: Optional[Dict]) -> TPLayout:
        """The layout of a plan's ``attn_ctx`` (one rank's: nothing cut,
        without one); under a mesh of more than one rank it refuses what
        the distributed steps do not take (``_check_distributable``)."""
        mesh = current_mesh()
        if attn_ctx and mesh is not None and math.prod(mesh.shape) > 1:
            self._check_distributable()
        return (attn_ctx or {}).get("layout", TPLayout())

    @staticmethod
    def _last(x: torch.Tensor, lens: torch.Tensor, lay: TPLayout
              ) -> torch.Tensor:
        """(B, d): each row's token at ``lens - 1`` of ``x`` (B, S, d);
        under ``lay.seq`` of the rank's slice (B, S/m, d): the rank that
        holds the token gives it, the others zeros, summed over "model"
        (exact)."""
        B, S_l = x.shape[:2]
        idx = torch.clamp(lens.long() - 1, min=0)
        rows = torch.arange(B, device=x.device)
        if not lay.seq:
            return x[rows, idx]
        from repro_torch.distributed.sharding import axis_index
        local = idx - axis_index("model") * S_l
        mine = (local >= 0) & (local < S_l)
        last = x[rows, torch.clamp(local, 0, S_l - 1)]
        return layers.reduce_model(last * mine[:, None].to(x.dtype))

    def prefill_chunk(self, params: Dict, tokens: torch.Tensor,
                      state: Dict, q_start: torch.Tensor,
                      q_lens: torch.Tensor, extra: Optional[Dict] = None,
                      impl: str = "kernel",
                      pages_per_block: Optional[int] = None,
                      num_splits: Optional[int] = None,
                      n_live: Optional[int] = None
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
        ``n_live``: the live tokens, ``sum(q_lens)``.

        Cross-attention K/V are projected only for the rows at their
        first chunk (``q_start == 0``, read on the host, as the JAX model
        reads it): every row (``full``, also when ``state`` holds no
        ``cross_k``), some of them (``partial``: their fresh K/V replace
        their rows of ``state["cross_k"]``/``["cross_v"]``, the other rows
        keep theirs) or none (``reuse``).  ``extra`` holds the image
        embeddings of every row of the batch.

        Recurrent (``R``, ``M``, ``S``) layers are not chunkable, as in
        the JAX package: their state would have to be carried across
        chunks.
        """
        cfg = self.cfg
        if self.n_rec_layers:
            raise UnsupportedFeature(
                "chunked prefill does not support recurrent layers "
                f"(pattern {cfg.layer_pattern!r}): carrying recurrent "
                "state across chunks is an open ROADMAP item",
                pattern=cfg.layer_pattern)
        B, C = tokens.shape
        live, n_live = self._live_tokens(q_lens, C, n_live)
        mode, rows, img = "reuse", None, None
        if self.n_cross_layers:
            mode, rows = attn.chunk_cross_mode(q_start, state)
            if mode == "full":
                img = self.project_extra(params, extra)
            elif mode == "partial":
                img = self.project_extra(params, {
                    "image_embeds": extra["image_embeds"][rows]})
        x = layers.embed_tokens(params["embed"], tokens)
        cross = []
        for li, p in enumerate(params["layers"]):
            h = layers.apply_norm(p["ln1"], x)
            if self.codes[li] == "C":
                k, v = attn.chunk_cross_kv(p["attn"], img, state,
                                           self.slot[li], mode, rows)
                cross.append((k, v))
                x = x + self._cross(p, h, k, v)
            else:
                ai = self.slot[li]
                x = x + attn.attn_prefill_chunked(
                    p["attn"], h, cfg, state["k_pages"][ai],
                    state["v_pages"][ai], state["tables"], q_start, q_lens,
                    window=self.windows[li], impl=impl,
                    pages_per_block=pages_per_block, num_splits=num_splits)
            x = self._apply_ffn(p, x, live, n_live)
        x = layers.apply_norm(params["ln_f"], x)
        last_idx = torch.clamp(q_lens.long() - 1, min=0)
        last = x[torch.arange(B, device=x.device), last_idx]
        logits = layers.unembed(params["embed"], last, cfg)
        out = dict(state, pos=q_start + q_lens)
        if cross:
            out["cross_k"] = torch.stack([k for k, _ in cross])
            out["cross_v"] = torch.stack([v for _, v in cross])
        return logits, out

    def decode_step(self, params: Dict, tokens: torch.Tensor, state: Dict,
                    impl: str = "kernel",
                    pages_per_block: Optional[int] = None,
                    num_splits: Optional[int] = None,
                    live: Optional[torch.Tensor] = None,
                    n_live: Optional[int] = None,
                    attn_ctx: Optional[Dict] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) → (logits (B, V), state with ``pos + 1``).  Each
        attention layer appends its K/V to the pools in place and attends
        over the pages through the block table (with the contiguous state:
        stores its K/V at ``pos`` in ``k_buf``/``v_buf`` and attends over
        the buffers); each recurrent layer steps its state in
        ``state["rec"]``, in place; each ``C`` layer attends over
        ``state["cross_k"]``/``["cross_v"]``.  ``live`` (B,) bool marks
        the rows whose tokens the MoE FFN routes (None: every row), and
        ``n_live`` counts them (read from ``live`` on the host when
        None).  ``attn_ctx``: the plan's (``launch.steps.Plan.attn_ctx``):
        the decode scheme under the active mesh
        (``attention.attn_decode``) and the ``layout`` of the rank's
        params; the params and state are then this rank's
        (``shard_params``, ``distributed.collectives.
        shard_decode_state``).  Under the layout's ``act_embed``
        (weight-stationary decode, ``plan_for(ws_decode=True)``) the
        residual stream is the rank's columns (B, d/n) of every row and
        the weights are read in place (``_gather_layer``): norms,
        products and logits sum their partials over those axes
        (``layers.ws_contract``).  An ``R`` block steps the rank's
        channels of its state under ``layout.state``.  Models of ``A``,
        ``W`` and ``R`` layers under a mesh."""
        cfg = self.cfg
        pos = state["pos"]
        lay = self._layout_of(attn_ctx)
        x = layers.embed_tokens(self._gather_top(params, "embed", lay),
                                tokens, lay.vocab)
        for li, p in enumerate(params["layers"]):
            p = self._gather_layer(li, p, lay)
            h = self._norm(p["ln1"], x, lay)
            code = self.codes[li]
            if code in REC_CODES:
                ri = self.slot[li]
                rec = state["rec"][code]
                o, new = REC_DECODE[code](
                    p["rec"], h, {k: v[ri] for k, v in rec.items()}, cfg,
                    **self._rec_kw(code, lay, decode=True))
                for k, v in new.items():
                    rec[k][ri] = v
            elif code == "C":
                ci = self.slot[li]
                o = self._cross(p, h, state["cross_k"][ci],
                                state["cross_v"][ci])
            else:
                o = attn.self_attn_decode(
                    p["attn"], h, cfg, state, self.slot[li],
                    window=self.windows[li], impl=impl,
                    pages_per_block=pages_per_block, num_splits=num_splits,
                    attn_ctx=attn_ctx, cut=lay.cut(li))
            x = self._apply_ffn(p, x + o, live, n_live, lay)
        x = self._norm(self._gather_top(params, "ln_f", lay), x, lay)
        logits = layers.unembed(self._gather_top(params, "embed", lay), x,
                                cfg, lay.vocab, ws=lay.act_embed)
        return logits, dict(state, pos=pos + 1)
