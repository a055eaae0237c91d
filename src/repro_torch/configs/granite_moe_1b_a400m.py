"""Granite-3.0-1B-A400M (MoE) [hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads (GQA kv=8), expert d_ff 512, vocab 49155,
32 experts top-8.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1_024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    activation="silu",
    rope_theta=10_000.0,
    n_experts=32,
    top_k=8,
    moe_capacity=1.25,  # Switch-style capacity factor (production dispatch bound)
    d_ff_expert=512,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
