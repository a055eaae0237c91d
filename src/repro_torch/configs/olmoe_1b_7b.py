"""OLMoE-1B-7B [arXiv:2409.02060].

16 layers, d_model 2048, 16 heads (kv=16), expert d_ff 1024, vocab 50304,
64 experts top-8.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1_024,
    vocab_size=50_304,
    activation="silu",
    rope_theta=10_000.0,
    n_experts=64,
    top_k=8,
    moe_capacity=1.25,  # Switch-style capacity factor (production dispatch bound)
    d_ff_expert=1_024,
    axis_overrides={"kv_heads": ("model",)},  # 16 kv heads == model axis
    source="arXiv:2409.02060",
)
