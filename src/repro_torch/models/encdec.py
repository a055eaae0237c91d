"""Whisper-style encoder-decoder (arXiv:2212.04356; port of
``repro.models.encdec``).

The mel-spectrogram and conv frontend are stubbed, as in the JAX package:
a request carries its frame embeddings, ``extra["frames"]`` of shape
(n_audio_frames, d_model).  The transformer is real: a bidirectional
encoder (K4 over the full mask under ``impl="kernel"``) and a causal
decoder whose every layer carries self-attention over the paged KV cache,
cross-attention over the encoder's output (K/V projected once per request
and kept per slot, ``cross_k``/``cross_v`` of shape (n_layers, B,
n_audio_frames, Hkv, D)) and an ungated GELU MLP.  Sinusoidal positions
(no RoPE), LayerNorm.

Parameters are the JAX tree with its stacks unstacked: ``embed``, ``enc``
(a list of ``n_encoder_layers`` dicts: ``ln1``, ``attn``, ``ln2``,
``mlp``), ``dec`` (a list of ``n_layers`` dicts: ``ln1``, ``self_attn``,
``lnx``, ``cross_attn``, ``ln2``, ``mlp``), ``ln_enc`` and ``ln_f``.

The entry points are ``TransformerModel``'s: ``forward`` and
``loss_fn`` for training (teacher-forced over ``encode(frames)``), and
for serving, over the same states:
``prefill`` and ``decode_step`` take the paged state or the contiguous
baseline's (``k_buf``/``v_buf``, and ``slots`` for ``prefill``), through
one loop; ``prefill_chunk`` the paged one.  As in the JAX package,
``prefill`` adds the f64 sinusoidal table cast to f32, ``prefill_chunk``
and ``decode_step`` the f32 closed form at their positions: the two
differ by the f32 rounding of the angles (≈ 1e-4 at 1500 positions, d
1024), so a chunked run differs from a monolithic one by that much.
Cross-attention runs the dense plain path, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.attention import TRAIN_IMPLS
from repro_torch.errors import InvalidRequest, UnsupportedFeature
from repro_torch.kernels import check_impl
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import spec as pspec


def _enc_layer_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": layers.norm_spec(cfg), "attn": attn.attn_spec(cfg),
            "ln2": layers.norm_spec(cfg), "mlp": layers.mlp_spec(cfg)}


def _dec_layer_spec(cfg: ModelConfig) -> Dict:
    return {"ln1": layers.norm_spec(cfg), "self_attn": attn.attn_spec(cfg),
            "lnx": layers.norm_spec(cfg), "cross_attn": attn.attn_spec(cfg),
            "ln2": layers.norm_spec(cfg), "mlp": layers.mlp_spec(cfg)}


class EncDecModel:
    """The encoder and the decoder; every decoder layer is an attention
    layer and a cross-attention layer.  The request's context is
    ``extra_key`` ("frames") of ``extra_shape``, projected to
    ``cross_len`` cross K/V rows per decoder layer."""

    def __init__(self, cfg: ModelConfig):
        if cfg.activation != "gelu_ungated":
            raise UnsupportedFeature("the encoder-decoder runs ungated GELU "
                                     f"MLPs, not {cfg.activation!r}",
                                     activation=cfg.activation)
        self.cfg = cfg
        self.n_attn_layers = cfg.n_layers  # decoder self-attention
        self.n_cross_layers = cfg.n_layers
        self.n_rec_layers = 0
        self.window = 0
        self.extra_key = "frames"
        self.extra_shape = (cfg.n_audio_frames, cfg.d_model)
        self.cross_len = cfg.n_audio_frames

    def param_spec(self) -> Dict:
        cfg = self.cfg
        return {"embed": layers.embed_spec(cfg),
                "enc": [_enc_layer_spec(cfg)
                        for _ in range(cfg.n_encoder_layers)],
                "dec": [_dec_layer_spec(cfg) for _ in range(cfg.n_layers)],
                "ln_enc": layers.norm_spec(cfg),
                "ln_f": layers.norm_spec(cfg)}

    def init_params(self, gen: torch.Generator, dtype=torch.float32,
                    device=None) -> Dict:
        return pspec.materialize(self.param_spec(), gen, dtype, device)

    def init_rec_state(self, B: int, dtype=torch.float32, device=None):
        return None  # no recurrent layers

    # ------------------------------------------------------------------
    def _frames(self, extra: Optional[Dict]) -> torch.Tensor:
        if not extra or "frames" not in extra:
            raise InvalidRequest(
                "the encoder-decoder needs extra['frames'] of shape (B, "
                f"{self.cfg.n_audio_frames}, {self.cfg.d_model})")
        return extra["frames"]

    def encode(self, params: Dict, frames: torch.Tensor,
               impl: str = "kernel") -> torch.Tensor:
        """frames: (B, F, d), the stubbed frontend's output (taken in the
        weights' dtype) → the encoder's output (B, F, d).  Its
        self-attention has no mask (K4's full mask under
        ``impl="kernel"``)."""
        cfg = self.cfg
        frames = frames.to(params["ln_enc"]["scale"].dtype)
        Fn = frames.shape[1]
        x = (frames + layers.sinusoidal_positions(
            Fn, cfg.d_model, frames.device)[None]).to(frames.dtype)
        for p in params["enc"]:
            h = layers.apply_norm(p["ln1"], x)
            x = x + attn.attn_train(p["attn"], h, cfg, causal=False,
                                    impl=impl)
            x = x + layers.apply_mlp(p["mlp"],
                                     layers.apply_norm(p["ln2"], x), cfg)
        return layers.apply_norm(params["ln_enc"], x)

    def _cross_mlp(self, p: Dict, x: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
        """The layer after its self-attention: cross-attention over (k,
        v), then the MLP."""
        cfg = self.cfg
        h = layers.apply_norm(p["lnx"], x)
        x = x + attn.cross_attn(p["cross_attn"], h, k, v, cfg)
        return x + layers.apply_mlp(p["mlp"], layers.apply_norm(p["ln2"], x),
                                    cfg)

    def forward(self, params: Dict, tokens: torch.Tensor,
                extra: Optional[Dict] = None, impl: str = "ref"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Teacher-forced decoder over (B, S) tokens and the encoding of
        ``extra["frames"]`` (B, F, d), the training path: (logits (B, S,
        V), a zero aux loss).  ``impl`` as ``TransformerModel.forward``
        takes it, for the encoder's and the decoder's self-attention."""
        check_impl(impl, TRAIN_IMPLS, "forward")
        cfg = self.cfg
        S = tokens.shape[1]
        enc = self.encode(params, self._frames(extra), impl)
        x = layers.embed_tokens(params["embed"], tokens)
        x = x + layers.sinusoidal_positions(S, cfg.d_model,
                                            x.device)[None].to(x.dtype)
        for p in params["dec"]:
            h = layers.apply_norm(p["ln1"], x)
            x = x + attn.attn_train(p["self_attn"], h, cfg, impl=impl)
            x = self._cross_mlp(p, x, *attn.cross_kv(p["cross_attn"], enc))
        x = layers.apply_norm(params["ln_f"], x)
        return (layers.unembed(params["embed"], x, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss_fn(self, params: Dict, batch: Dict, impl: str = "ref",
                attn_ctx: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """batch: {"inputs", "targets", "frames", "mask"?} → (ce, {"ce",
        "aux"}).  A train plan's ``attn_ctx`` (the step across ranks) is
        refused: the encoder-decoder is not distributed."""
        if attn_ctx:
            raise UnsupportedFeature(
                "the distributed train step takes models of 'A', 'W' and 'R' "
                "layers; family 'encdec'", family="encdec")
        logits, aux = self.forward(params, batch["inputs"],
                                   {"frames": batch["frames"]}, impl)
        ce = layers.xent(logits, batch["targets"], batch.get("mask"))
        return ce, {"ce": ce, "aux": aux}

    @staticmethod
    def _last(params: Dict, x: torch.Tensor, lens: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
        x = layers.apply_norm(params["ln_f"], x)
        idx = torch.clamp(lens.long() - 1, min=0)
        last = x[torch.arange(x.shape[0], device=x.device), idx]
        return layers.unembed(params["embed"], last, cfg)

    def prefill(self, params: Dict, tokens: torch.Tensor, state: Dict,
                lens: Optional[torch.Tensor] = None,
                extra: Optional[Dict] = None, impl: str = "kernel",
                n_live: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B, S) prompts (right-padded), ``extra["frames"]`` (B,
        F, d).  Encodes the frames, runs the decoder over the prompts
        (self-attention K/V into the pools, or by position into the
        contiguous buffer rows ``state["slots"]``, in place) and returns
        (last-token logits (B, V), the state with ``pos = lens`` and the
        rows' ``cross_k``/``cross_v``).  ``n_live`` is unused (no MoE)."""
        check_impl(impl, entry="prefill")
        cfg = self.cfg
        B, S = tokens.shape
        if lens is None:
            lens = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
        enc = self.encode(params, self._frames(extra), impl)
        x = layers.embed_tokens(params["embed"], tokens)
        x = x + layers.sinusoidal_positions(S, cfg.d_model,
                                            x.device)[None].to(x.dtype)
        cks, cvs = [], []
        for li, p in enumerate(params["dec"]):
            h = layers.apply_norm(p["ln1"], x)
            o = attn.self_attn_prefill(p["self_attn"], h, cfg, state, li,
                                       lens, impl=impl)
            k, v = attn.cross_kv(p["cross_attn"], enc)
            cks.append(k)
            cvs.append(v)
            x = self._cross_mlp(p, x + o, k, v)
        out = dict(state, pos=lens, cross_k=torch.stack(cks),
                   cross_v=torch.stack(cvs))
        return self._last(params, x, lens, cfg), out

    def prefill_chunk(self, params: Dict, tokens: torch.Tensor,
                      state: Dict, q_start: torch.Tensor,
                      q_lens: torch.Tensor, extra: Optional[Dict] = None,
                      impl: str = "kernel",
                      pages_per_block: Optional[int] = None,
                      num_splits: Optional[int] = None,
                      n_live: Optional[int] = None
                      ) -> Tuple[torch.Tensor, Dict]:
        """Chunked decoder prefill, with ``TransformerModel.prefill_chunk``'s
        contract: the chunk's self-attention resumes from the cached
        prefix pages at ``q_start`` (K3 under ``impl="kernel"``).  Only
        the rows at their first chunk (``q_start == 0``, read on the host,
        as the JAX model reads it) run the encoder: every row (``full``,
        also when ``state`` holds no ``cross_k``), some (``partial``:
        their frames are encoded as a smaller batch and their fresh cross
        K/V replace their rows of the state's) or none (``reuse``)."""
        cfg = self.cfg
        C = tokens.shape[1]
        dev = tokens.device
        mode, rows = attn.chunk_cross_mode(q_start, state)
        enc = None
        if mode == "full":
            enc = self.encode(params, self._frames(extra), impl)
        elif mode == "partial":
            enc = self.encode(params, self._frames(extra)[rows], impl)
        pos = q_start.long()[:, None] + torch.arange(C, device=dev)[None]
        x = layers.embed_tokens(params["embed"], tokens)
        x = x + layers.sinusoidal_at(pos, cfg.d_model).to(x.dtype)
        cks, cvs = [], []
        for li, p in enumerate(params["dec"]):
            h = layers.apply_norm(p["ln1"], x)
            o = attn.attn_prefill_chunked(
                p["self_attn"], h, cfg, state["k_pages"][li],
                state["v_pages"][li], state["tables"], q_start, q_lens,
                impl=impl, pages_per_block=pages_per_block,
                num_splits=num_splits)
            k, v = attn.chunk_cross_kv(p["cross_attn"], enc, state, li,
                                       mode, rows)
            cks.append(k)
            cvs.append(v)
            x = self._cross_mlp(p, x + o, k, v)
        out = dict(state, pos=q_start + q_lens, cross_k=torch.stack(cks),
                   cross_v=torch.stack(cvs))
        return self._last(params, x, q_lens, cfg), out

    def decode_step(self, params: Dict, tokens: torch.Tensor, state: Dict,
                    impl: str = "kernel",
                    pages_per_block: Optional[int] = None,
                    num_splits: Optional[int] = None,
                    live: Optional[torch.Tensor] = None,
                    n_live: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens: (B,) → (logits (B, V), state with ``pos + 1``).  Each
        decoder layer appends its K/V (to the pools through the block
        table, or at ``pos`` in the contiguous buffers), attends over
        them (K1 and K2 on the pools under ``impl="kernel"``) and
        cross-attends over ``state["cross_k"]``/``["cross_v"]``.  ``live``
        and ``n_live`` are unused (no MoE)."""
        cfg = self.cfg
        pos = state["pos"]
        x = layers.embed_tokens(params["embed"], tokens)
        x = x + layers.sinusoidal_at(pos, cfg.d_model).to(x.dtype)
        for li, p in enumerate(params["dec"]):
            h = layers.apply_norm(p["ln1"], x)
            o = attn.self_attn_decode(
                p["self_attn"], h, cfg, state, li, impl=impl,
                pages_per_block=pages_per_block, num_splits=num_splits)
            x = self._cross_mlp(p, x + o, state["cross_k"][li],
                                state["cross_v"][li])
        x = layers.apply_norm(params["ln_f"], x)
        return layers.unembed(params["embed"], x, cfg), dict(state,
                                                             pos=pos + 1)
