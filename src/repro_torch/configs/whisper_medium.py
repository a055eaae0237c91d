"""Whisper-medium [arXiv:2212.04356].

Encoder-decoder: 24 encoder + 24 decoder layers, d_model 1024, 16 heads
(MHA kv=16), d_ff 4096, vocab 51865.  The mel-spectrogram + conv frontend is
stubbed per the harness carve-out: input_specs() provides
(batch, 1500, d_model) frame embeddings.  Decoder self-attention uses the
paged KV cache; cross-attention KV over encoder frames is fixed-length.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4_096,
    vocab_size=51_865,
    activation="gelu_ungated",
    norm="layernorm",
    tie_embeddings=True,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    n_audio_frames=1_500,
    max_target_positions=448,
    axis_overrides={"kv_heads": ("model",)},
    source="arXiv:2212.04356",
)
