"""Nemotron-4-340B [arXiv:2402.16819].

96 layers, d_model 18432, 96 heads (GQA kv=8), d_ff 73728, vocab 256000,
squared-ReLU MLP (no gating), LayerNorm, RoPE.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    axis_overrides={"embed": ("data",)},  # FSDP: 340B params
    decode_scheme="kvp",
    source="arXiv:2402.16819",
)
