"""Next-token NLL of trained weights, two ways (the paper's §IV-B3
numerical-equivalence check, the method of the JAX package's
``benchmarks/tbl_perplexity.py``):

  * ``teacher_forced_nll`` — one ``forward`` over the whole sequences;
  * ``paged_decode_nll``   — ``prefill`` of the first token, then one
    ``decode_step`` per token against a paged KV cache, each step's
    logits scoring the next token.

Both run under ``torch.no_grad()`` and return the mean NLL over the
(B, S - 1) predicted tokens as an f32 scalar tensor.  With
``impl="kernel"`` the first goes through K4 and the second through K1
and K2 (K4 for the one-token prefill).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models import layers


@torch.no_grad()
def teacher_forced_nll(model, params: Dict, tokens: torch.Tensor,
                       extra: Optional[Dict] = None,
                       impl: str = "ref") -> torch.Tensor:
    logits, _ = model.forward(params, tokens, extra, impl)
    return layers.xent(logits[:, :-1], tokens[:, 1:])


@torch.no_grad()
def paged_decode_nll(model, params: Dict, tokens: torch.Tensor,
                     extra: Optional[Dict] = None,
                     page_size: Optional[int] = None,
                     impl: str = "kernel") -> torch.Tensor:
    """``tokens`` (B, S): each row owns ``ceil(S / page_size)`` pages of a
    pool in the weights' dtype (pages of the config's size by default)."""
    cfg = model.cfg
    B, S = tokens.shape
    dev = tokens.device
    P = page_size or cfg.page_size
    pps = -(-S // P)
    dtype = params["ln_f"]["scale"].dtype
    pool = (model.n_attn_layers, B * pps, P, cfg.n_kv_heads,
            cfg.resolved_head_dim)
    state = {"pos": torch.ones(B, dtype=torch.int32, device=dev),
             "tables": torch.arange(B * pps, dtype=torch.int32,
                                    device=dev).reshape(B, 1, pps),
             "k_pages": torch.zeros(pool, dtype=dtype, device=dev),
             "v_pages": torch.zeros(pool, dtype=dtype, device=dev)}
    logits, state = model.prefill(params, tokens[:, :1], state,
                                  extra=extra, impl=impl)
    nll = []
    for t in range(1, S):
        lp = torch.log_softmax(logits.float(), dim=-1)
        nll.append(-lp.gather(1, tokens[:, t, None].long())[:, 0])
        if t < S - 1:
            logits, state = model.decode_step(params, tokens[:, t], state,
                                              impl=impl)
    return torch.stack(nll).mean()
