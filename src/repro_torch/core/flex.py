"""FlexAttention-style composable masking (port of ``repro.core.flex``).

  * mask mods are vectorisable predicates over (b, h, q, k) index tensors;
  * ``and_masks`` composes them;
  * ``build_block_mask`` compiles a mod into a ``BlockMask`` — per q-block
    lists of live kv-blocks plus a full/partial flag — which the flex
    prefill kernel (K4) uses to skip fully-masked tiles and to elide the
    element-wise mask on full tiles.

All mods broadcast: inputs are integer tensors, the output a bool tensor.
Composite mods keep their parts (``.parts``) so the CUDA kernel can map a
composition of known mods onto one of its compiled mask variants.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

MaskMod = Callable[..., torch.Tensor]  # (b, h, q_idx, kv_idx) -> bool
ScoreMod = Callable[..., torch.Tensor]  # (score, b, h, q_idx, kv_idx) -> score


class AuxMod:
    """A mask mod that reads auxiliary tensors (FlexAttention's "passed
    as bias" trick): ``fn(b, h, q, k, *aux)``."""

    def __init__(self, fn: Callable, aux: Sequence[torch.Tensor],
                 parts: Sequence = ()):
        self.fn = fn
        self.aux = tuple(aux)
        self.parts = tuple(parts)

    def __call__(self, *args):
        return self.fn(*args, *self.aux)


def _split(mods):
    """Flatten (fn, n_aux, aux) triples out of a mod list."""
    fns, counts, aux = [], [], []
    for m in mods:
        if isinstance(m, AuxMod):
            fns.append(m.fn)
            counts.append(len(m.aux))
            aux.extend(m.aux)
        else:
            fns.append(m)
            counts.append(0)
    return fns, counts, tuple(aux)


# ---------------------------------------------------------------------------
# mask mods
# ---------------------------------------------------------------------------
def full_mask(b, h, q, k):
    q, k = torch.as_tensor(q), torch.as_tensor(k)
    return torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                      dtype=torch.bool, device=q.device)


def causal_mask(b, h, q, k):
    return k <= q


def sliding_window_mask(window: int) -> MaskMod:
    def mod(b, h, q, k):
        return (k <= q) & (q - k < window)

    return mod


def _padding_fn(b, h, q, k, lens):
    return k < lens[b]


def padding_mask(lens: torch.Tensor) -> MaskMod:
    """lens: (B,) — kv positions past a sequence's length are dead."""
    return AuxMod(_padding_fn, (lens,))


def _combine(op, mods):
    fns, counts, aux = _split(mods)

    def fn(b, h, q, k, *aux_in):
        out = None
        i = 0
        for f, n in zip(fns, counts):
            r = f(b, h, q, k, *aux_in[i:i + n])
            i += n
            out = r if out is None else op(out, r)
        return out

    if aux:
        return AuxMod(fn, aux, parts=mods)

    def plain(b, h, q, k):
        return fn(b, h, q, k)

    plain.parts = tuple(mods)
    return plain


def and_masks(*mods: MaskMod) -> MaskMod:
    return _combine(lambda a, b: a & b, mods)


# ---------------------------------------------------------------------------
# score mods
# ---------------------------------------------------------------------------
def softcap_score(cap: float) -> ScoreMod:
    def mod(score, b, h, q, k):
        return cap * torch.tanh(score / cap)

    return mod


# ---------------------------------------------------------------------------
# BlockMask compilation
# ---------------------------------------------------------------------------
class BlockMask(NamedTuple):
    """FlexAttention-style compiled sparsity.

    kv_num_blocks: ([B,] num_q_blocks,) int32 — live kv blocks per q block
    kv_indices:    ([B,] num_q_blocks, max_blocks) int32 — their indices,
                   live blocks first
    is_full:       ([B,] num_q_blocks, max_blocks) bool — True ⇒ the tile
                   needs no element-wise mask
    """

    kv_num_blocks: torch.Tensor
    kv_indices: torch.Tensor
    is_full: torch.Tensor
    q_block: int
    kv_block: int

    @property
    def batched(self) -> bool:
        return self.kv_indices.dim() == 3


def build_block_mask(mod: MaskMod, Q: int, K: int, q_block: int = 128,
                     kv_block: int = 128, B: Optional[int] = None,
                     device=None) -> BlockMask:
    """Compile a mask mod into block sparsity (FlexAttention's
    create_block_mask).  Pass ``B`` for batch-dependent mods; the mask is
    evaluated one batch row at a time."""
    if device is None:
        aux = mod.aux if isinstance(mod, AuxMod) else ()
        device = aux[0].device if aux else torch.device("cpu")
    nq = -(-Q // q_block)
    nk = -(-K // kv_block)
    q = torch.arange(nq * q_block, device=device)[:, None]
    k = torch.arange(nk * kv_block, device=device)[None, :]
    valid = (q < Q) & (k < K)
    in_range = valid.reshape(nq, q_block, nk, kv_block)

    anys, alls = [], []
    for b in range(B if B is not None else 1):
        m = mod(torch.tensor(b, device=device), 0, q, k) & valid
        m = m.reshape(nq, q_block, nk, kv_block)
        any_live = m.any(dim=3).any(dim=1)
        anys.append(any_live)
        alls.append((m | ~in_range).all(dim=3).all(dim=1) & any_live)
    any_live = torch.stack(anys) if B is not None else anys[0]
    all_live = torch.stack(alls) if B is not None else alls[0]

    counts = any_live.sum(dim=-1).to(torch.int32)
    # live blocks first, in index order
    order = torch.sort((~any_live).to(torch.int8), dim=-1, stable=True)[1]
    return BlockMask(kv_num_blocks=counts,
                     kv_indices=order.to(torch.int32),
                     is_full=torch.gather(all_live, -1, order),
                     q_block=q_block, kv_block=kv_block)


def causal_block_mask(Q: int, K: int, q_block: int = 128, kv_block: int = 128,
                      window: int = 0, device=None) -> BlockMask:
    """Analytic fast path (no mask evaluation) for causal / sliding-window."""
    nq = -(-Q // q_block)
    nk = -(-K // kv_block)
    qb = np.arange(nq)
    q_lo = qb * q_block
    q_hi = np.minimum(q_lo + q_block, Q) - 1
    hi_block = q_hi // kv_block  # last block any q in this row can see
    if window > 0:
        lo_block = np.maximum(q_lo - window + 1, 0) // kv_block
    else:
        lo_block = np.zeros_like(qb)
    counts = (hi_block - lo_block + 1).astype(np.int32)
    kv_indices = np.zeros((nq, nk), np.int32)
    is_full = np.zeros((nq, nk), bool)
    for i in range(nq):
        idx = np.arange(lo_block[i], hi_block[i] + 1)
        kv_indices[i, : counts[i]] = idx
        # full iff the tile's last kv pos <= the row's first q pos (causal
        # interior) and, with a window, its first kv pos is inside it
        full = idx * kv_block + kv_block - 1 <= q_lo[i]
        if window > 0:
            full &= idx * kv_block >= q_hi[i] - window + 1
        is_full[i, : counts[i]] = full
    dev = device if device is not None else torch.device("cpu")
    return BlockMask(
        kv_num_blocks=torch.as_tensor(counts, device=dev),
        kv_indices=torch.as_tensor(kv_indices, device=dev),
        is_full=torch.as_tensor(is_full, device=dev),
        q_block=q_block, kv_block=kv_block)
