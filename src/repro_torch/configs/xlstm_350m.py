"""xLSTM-350M [arXiv:2405.04517].

24 blocks, d_model 1024, 4 heads, vocab 50304.  sLSTM + mLSTM mix: the paper's
xLSTM[7:1] ratio — one sLSTM block per 8, rest mLSTM.  Attention-free: the
paged-KV technique does not apply (O(1) recurrent state; see DESIGN.md
§Arch-applicability).  d_ff=0: blocks carry their own up/down projections.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1_024,
    n_heads=4,
    n_kv_heads=4,
    head_dim=256,
    d_ff=0,
    vocab_size=50_304,
    layer_pattern="MMMMMMMS",  # 7 mLSTM : 1 sLSTM
    paged_attention=False,
    source="arXiv:2405.04517",
)
