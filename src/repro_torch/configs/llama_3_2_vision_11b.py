"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision].

Language backbone: 40 layers, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 128256, with a cross-attention (image) layer every 5th layer.
The ViT vision encoder is stubbed per the harness carve-out: input_specs()
provides (batch, n_image_tokens, d_model) projected patch embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=128_256,
    activation="silu",
    rope_theta=500_000.0,
    n_image_tokens=1_601,
    cross_attn_every=5,
    layer_pattern="CAAAA",  # cross-attn layer leads each group of 5
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
