"""Nemotron-4-15B [arXiv:2402.16819].

32 layers, d_model 6144, 48 heads (GQA kv=8), d_ff 24576, vocab 256000,
squared-ReLU MLP, LayerNorm.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6_144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=256_000,
    activation="relu2",
    norm="layernorm",
    rope_theta=10_000.0,
    axis_overrides={"embed": ("data",)},
    source="arXiv:2402.16819",
)
