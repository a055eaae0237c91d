"""Model / run configuration system.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
``family`` selects the model builder in ``repro.models``; everything else is
data.  ``smoke()`` derives the reduced CPU-testable variant mandated by the
harness (≤2 layers, d_model ≤ 512, ≤4 experts).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assigned): name -> (seq_len, global_batch, kind)
# ---------------------------------------------------------------------------
INPUT_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_4k": dict(seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524_288, global_batch=1, kind="decode"),
}


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | xlstm | rglru | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    activation: str = "silu"  # silu | relu2 | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    rope_theta: float = 500_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0  # expert hidden size (granite/olmoe use d_ff as expert size)
    router_aux_coef: float = 0.01
    # Switch-style expert capacity factor; 0 => dropless (C = T, exact).
    # Production MoE training uses a finite factor so dispatch buffers are
    # O(T·k/E), not O(T·E); routing/drops are identical across forward/
    # prefill/decode paths, so numerical-equivalence tests still hold.
    moe_capacity: float = 0.0
    # explicit shard_map expert parallelism (distributed/ep.py) instead of
    # the GSPMD-annotated dispatch; beyond-paper §Perf H1 optimization
    moe_ep: bool = False

    # --- hybrid / pattern ---
    # layer_pattern: string of block codes, tiled to n_layers.
    #   'A' global attention   'W' sliding-window attention
    #   'R' RG-LRU recurrent   'M' mLSTM    'S' sLSTM
    #   'C' cross-attention + self-attention (VLM)
    layer_pattern: str = "A"
    window: int = 0  # sliding-window size for 'W' layers
    conv1d_width: int = 4  # RG-LRU temporal conv width
    lru_width: int = 0  # RG-LRU recurrent width (0 -> d_model)

    # --- enc-dec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_frames: int = 1500
    max_target_positions: int = 448

    # --- vlm ---
    n_image_tokens: int = 1601
    cross_attn_every: int = 5  # one cross-attn layer per N layers
    d_vision: int = 1280  # stubbed ViT output width (projector input)

    # --- paged KV cache (the paper's technique) ---
    page_size: int = 64
    paged_attention: bool = True  # paper flag: drop-in enable/disable
    # beyond-paper (§Perf H3): store KV pages in int8 with a fixed
    # symmetric scale — halves decode's dominant HBM traffic (lossy;
    # the paper's C1 exact-equivalence claim applies to kv_dtype="bf16")
    kv_dtype: str = "base"  # "base" (= activation dtype) | "int8"
    kv_scale: float = 0.05  # int8 dequant step (calibration knob)

    # fully unroll the layer-group scan (used by the dry-run's L1/L2 cost
    # probes: XLA's cost_analysis counts a while-loop body ONCE regardless
    # of trip count, so the probes must lower loop-free — DESIGN.md §7)
    scan_unroll: bool = False

    # --- numerics / distribution ---
    dtype: str = "float32"
    param_dtype: str = "float32"
    remat: str = "none"  # none | dots | full
    axis_overrides: Dict[str, Any] = field(default_factory=dict)
    # decode sharding scheme: "tp" (vLLM-style: batch x data, heads x model,
    # KV replicated over model) or "kvp" (flash-decoding: pages sharded over
    # model too, online-softmax psum combine). "auto" picks by KV size.
    decode_scheme: str = "auto"
    source: str = ""  # citation

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def expert_ff(self) -> int:
        return self.d_ff_expert or self.d_ff

    def pattern(self) -> str:
        """Per-layer block codes, length n_layers."""
        pat = self.layer_pattern
        reps = -(-self.n_layers // len(pat))
        return (pat * reps)[: self.n_layers]

    def smoke(self) -> "ModelConfig":
        """Reduced variant of the same family for CPU smoke tests."""
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        d_model = min(self.d_model, 256)
        updates: Dict[str, Any] = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=d_model // n_heads,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            page_size=8,
            window=min(self.window, 64) if self.window else 0,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            remat="none",
        )
        if self.is_moe:
            updates.update(n_experts=4, top_k=2, d_ff_expert=64)
        if self.n_encoder_layers:
            updates.update(n_encoder_layers=2, n_audio_frames=16)
        if self.family == "vlm":
            updates.update(n_image_tokens=8, cross_attn_every=2,
                           layer_pattern="CA")  # both block types in 2 layers
        if self.family == "rglru":
            updates.update(conv1d_width=4, layer_pattern="RW")
        if self.family == "xlstm":
            updates.update(layer_pattern="MS")
        return replace(self, **updates)

    def replace(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class RunConfig:
    """A fully-specified runnable: model + input shape + paging pool."""

    model: ModelConfig
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode
    variant: str = "base"  # base | swa (sliding-window long-context variant)
    # pool slack: pages beyond the exact requirement, power-of-two rounded
    pool_slack: float = 1.0

    @property
    def pages_per_seq(self) -> int:
        ps = self.model.page_size
        return -(-self.seq_len // ps)

    @property
    def num_pages(self) -> int:
        exact = self.global_batch * self.pages_per_seq
        n = max(1, int(exact * self.pool_slack))
        # paper §IV-B1: power-of-two pool allocations
        p = 1
        while p < n:
            p <<= 1
        return p


def make_run(model: ModelConfig, shape_name: str, variant: str = "base") -> RunConfig:
    spec = INPUT_SHAPES[shape_name]
    m = model
    if variant == "swa" and m.family in ("dense", "moe", "vlm"):
        # beyond-paper sliding-window variant for sub-quadratic long context
        pat = "W" if m.family != "vlm" else m.layer_pattern.replace("A", "W")
        m = m.replace(layer_pattern=pat, window=m.window or 4096)
    return RunConfig(model=m, seq_len=spec["seq_len"],
                     global_batch=spec["global_batch"], kind=spec["kind"],
                     variant=variant)
