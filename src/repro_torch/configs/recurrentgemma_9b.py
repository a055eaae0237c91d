"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38 layers, d_model 4096, 16 heads (MQA kv=1), d_ff 12288, vocab 256000.
Pattern: 2 RG-LRU recurrent blocks then 1 local sliding-window attention
(window 2048) — "1:2" attention:recurrent.  The local-attention layers use a
bounded *ring of pages* KV cache (pages past the window are freed).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="rglru",
    n_layers=38,
    d_model=4_096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    activation="gelu",
    layer_pattern="RRW",
    window=2_048,
    lru_width=4_096,
    conv1d_width=4,
    logit_softcap=30.0,
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
)
