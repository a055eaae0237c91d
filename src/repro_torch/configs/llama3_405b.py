"""Llama-3 405B [arXiv:2407.21783].

126 layers, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16_384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53_248,
    vocab_size=128_256,
    activation="silu",
    rope_theta=500_000.0,
    axis_overrides={"embed": ("data",)},  # FSDP: 405B params
    decode_scheme="kvp",
    source="arXiv:2407.21783",
)
