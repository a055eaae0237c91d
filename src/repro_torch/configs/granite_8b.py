"""Granite-8B-Code [arXiv:2405.04324].

36 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 49152,
llama-style (SwiGLU, RMSNorm), tied embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    n_layers=36,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=49_152,
    activation="silu",
    rope_theta=10_000_000.0,
    tie_embeddings=True,
    axis_overrides={"embed": ("data",)},
    source="arXiv:2405.04324",
)
