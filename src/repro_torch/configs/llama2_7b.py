"""LLaMA-7B — the paper's own evaluation model (32 heads, d_model 4096).

Used by the paper-claims benchmarks (latency/memory/perplexity-equivalence).
MHA (kv = heads = 32), SwiGLU, RMSNorm, vocab 32000.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b",
    family="dense",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11_008,
    vocab_size=32_000,
    activation="silu",
    rope_theta=10_000.0,
    source="paper §III-B / arXiv:2302.13971",
)
