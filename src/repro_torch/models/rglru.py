"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427;
port of ``repro.models.rglru``).

    r_t = σ(W_a x_t)                    (recurrence gate)
    i_t = σ(W_x x_t)                    (input gate)
    log a_t = -c · softplus(Λ) · r_t    (c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 − a_t²) ⊙ (i_t ⊙ x̃_t)

x̃ is the branch mixed by a causal temporal conv of width ``conv1d_width``.
The block is Griffin's recurrent block: two input projections (the
recurrent branch and a GeLU gate branch), the conv, the RG-LRU, the gated
merge and the output projection.

Prefill runs the recurrence as a log-depth doubling scan over time with
the JAX package's ``combine`` — ``(a1 + a2, b1 · exp(a2) + b2)``, the
decays kept in log space — in plain PyTorch: the JAX package has no
Pallas kernel for it (it uses ``jax.lax.associative_scan``), and a Python
loop over thousands of positions per layer would launch thousands of
small operations.  Decode carries ``(h, conv window)``: O(1) state per
sequence.

Under a mesh the block takes the switches of ``layers.apply_mlp``
(``distributed.sharding.TPLayout``): ``cut`` (``TPLayout.state``) — the
rank holds ``w/m`` of the channels: ``wx``/``wy`` by columns (the MLP's
``wg``/``wu``), ``wout`` by rows (its ``wd``), the conv, ``conv_b``,
``a_log`` and the state by channel, and ``wa``/``wi`` by rows, so that
the rank's gate products are partial sums over the whole ``w``, summed
in f32 and reduce-scattered in one call (``_gate_sums``) before the
sigmoid; ``seq`` (``TPLayout.seq``) — the rank holds its slice of the
sequence between blocks, gathered whole at entry (the conv and the scan
need every earlier position) and reduce-scattered from ``wout``'s
partial sums at exit; ``ws`` (``TPLayout.act_embed``, decode) — ``x``
and the output are the rank's columns of ``embed``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec

_C = 8.0  # Griffin's fixed temperature on the log-recurrence


def rglru_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width
    return {
        "wx": ParamSpec((d, w), ("embed", "state")),
        "wy": ParamSpec((d, w), ("embed", "state")),  # GeLU gate branch
        "conv": ParamSpec((cw, w), (None, "state"), "small_normal"),
        "conv_b": ParamSpec((w,), ("state",), "zeros"),
        "wa": ParamSpec((w, w), ("state", None), "small_normal"),
        "wi": ParamSpec((w, w), ("state", None), "small_normal"),
        "a_log": ParamSpec((w,), ("state",), "a_log"),
        "wout": ParamSpec((w, d), ("state", "embed")),
    }


def _gate_sums(p: Dict, xc: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xc @ wa, xc @ wi)`` over the whole ``w`` for a rank that holds
    ``w/m`` channels of ``xc`` and the matching rows of ``wa``/``wi``
    (``TPLayout.state``): each rank's f32 partials of both products,
    packed rank-major by the columns they feed (rank j's block holds
    its ``r`` columns, then its ``i`` columns), are reduce-scattered
    over "model" in one call, so that the rank keeps the sums of its own
    ``w/m`` columns of each gate; in ``xc``'s dtype.  Under autograd the
    gradient of those columns comes back as the whole partials' (the
    reduce-scatter's backward is the all-gather)."""
    from repro_torch.distributed.collectives import scatter_dim
    from repro_torch.models.layers import _partial
    wl, w = p["wa"].shape
    m = w // wl
    packed = torch.stack([p["wa"].reshape(wl, m, wl),
                          p["wi"].reshape(wl, m, wl)], dim=2).reshape(wl,
                                                                      2 * w)
    # (2w, T): dim 0 in m blocks, one a rank, so the scatter needs no copy
    part = _partial(packed.T, xc.reshape(-1, wl).T)
    mine = scatter_dim(part, ("model",), 0).T  # (T, 2 w/m)
    ra, ia = mine.reshape(*xc.shape[:-1], 2, wl).unbind(-2)
    return ra.to(xc.dtype), ia.to(xc.dtype)


def _gates(p: Dict, xb: torch.Tensor, cut: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xb: (..., w) conv-mixed branch → (log a_t in f32, gated input in
    xb's dtype), with the JAX package's casts.  ``cut``: ``xb`` holds the
    rank's channels, and so do the results (``_gate_sums``)."""
    ra, ia = _gate_sums(p, xb) if cut else (xb @ p["wa"], xb @ p["wi"])
    r = torch.sigmoid(ra).float()
    i = torch.sigmoid(ia)
    a_log = p["a_log"]
    softplus = torch.logaddexp(a_log, torch.zeros_like(a_log))
    log_a = -_C * r * softplus  # log a_t (a_t in (0, 1))
    a2 = torch.exp(2 * log_a)
    gated = torch.sqrt(torch.clamp(1 - a2, min=1e-12)).to(xb.dtype) * i * xb
    return log_a, gated


def _conv_branch(p: Dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (xb left-padded by cw - 1 zero rows, the causal conv
    of xb (B, S, w))."""
    S = x.shape[1]
    xb = x @ p["wx"]
    cw = p["conv"].shape[0]
    pad = F.pad(xb, (0, 0, cw - 1, 0))
    xc = sum(pad[:, i:i + S] * p["conv"][i] for i in range(cw)) + p["conv_b"]
    return pad, xc


def linear_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over dim 1 from h_{-1} = 0: the
    inclusive scan of ``combine((a1, b1), (a2, b2)) = (a1 + a2, b1 ·
    exp(a2) + b2)``, by doubling (Hillis–Steele): after the step of
    distance k each position holds the combine of its last 2k inputs, so
    ceil(log2 S) steps of whole-tensor operations."""
    a, h = log_a, b
    k, S = 1, b.shape[1]
    while k < S:
        h = torch.cat([h[:, :k],
                       h[:, :-k] * torch.exp(a[:, k:]).to(h.dtype)
                       + h[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, :-k] + a[:, k:]], dim=1)
        k *= 2
    return h


def _block(p: Dict, x: torch.Tensor, cut: bool = False
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The block over whole sequences up to ``wout``: (``h · y``, h at
    every position, the padded xb the conv window is cut from), on the
    rank's channels under ``cut``."""
    pad, xc = _conv_branch(p, x)
    log_a, gated = _gates(p, xc, cut)
    h = linear_scan(log_a, gated)
    y = F.gelu(x @ p["wy"], approximate="tanh")  # jax.nn.gelu's default
    return h * y, h, pad


def _out(p: Dict, hy: torch.Tensor, cut: bool, seq: bool = False
         ) -> torch.Tensor:
    """``hy @ wout``; under ``cut`` the rank's rows' partial sums reduced
    over "model" in f32 (under ``seq`` reduce-scattered along the
    sequence: ``layers.row_parallel_matmul``)."""
    if cut:
        from repro_torch.models.layers import row_parallel_matmul
        return row_parallel_matmul(hy, p["wout"], seq)
    return hy @ p["wout"]


def _enter(x: torch.Tensor, cut: bool, seq: bool) -> torch.Tensor:
    """The block's input over whole sequences: under ``seq`` the rank's
    slice gathered (its gradient summed over "model" and cut back to the
    slice under ``cut``, where every rank computes its own channels; the
    rank's slice otherwise), under ``cut`` alone with its gradient summed
    over "model"."""
    from repro_torch.models import layers
    if seq:
        return layers.seq_gather(x, summed=cut)
    return layers.copy_model(x) if cut else x


def rglru_train(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                cut: bool = False, seq: bool = False) -> torch.Tensor:
    """x: (B, S, d) → (B, S, d) over whole sequences; ``cut``/``seq``
    (module docstring): the rank's channels, the rank's slice of the
    sequence in and out."""
    x = _enter(x, cut, seq)
    if seq and not cut:  # every rank runs the block whole
        from repro_torch.models.layers import seq_split
        return seq_split(rglru_train(p, x, cfg))
    return _out(p, _block(p, x, cut)[0], cut, seq)


def rglru_prefill(p: Dict, x: torch.Tensor, lens: torch.Tensor,
                  cfg: ModelConfig, cut: bool = False, seq: bool = False
                  ) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) right-padded prompts of ``lens`` tokens → (the block's
    output (B, S, d), the decode state after each row's last token).

    The state is taken at row b's position ``lens[b] - 1``: h there, and
    the conv window of its last cw - 1 real positions (zeros before
    position 0), so a row's state does not depend on the padding of the
    rows beside it.  (The JAX package's prefill takes every row's state at
    the padded end, ``hs[:, -1]``; the two agree on rows of the full
    length.)  ``cut``/``seq`` as ``rglru_train``: the state holds the
    rank's channels, taken from the whole sequence."""
    x = _enter(x, cut, seq)
    hy, h, pad = _block(p, x, cut)
    if seq and not cut:
        from repro_torch.models.layers import seq_split
        out = seq_split(_out(p, hy, False))
    else:
        out = _out(p, hy, cut, seq)
    B = x.shape[0]
    cw = p["conv"].shape[0]
    last = torch.clamp(lens.long() - 1, min=0)
    rows = torch.arange(B, device=x.device)
    # pad position j holds xb position j - (cw - 1): the window of the row's
    # last cw - 1 positions starts at pad position lens
    cols = last[:, None] + 1 + torch.arange(cw - 1, device=x.device)
    return out, {"h": h[rows, last], "conv": pad[rows[:, None], cols]}


def rglru_init_state(B: int, cfg: ModelConfig, dtype=torch.float32,
                     device=None, parts: int = 1) -> Dict:
    """The zero state of ``B`` sequences; ``parts``: the channels are cut
    into that many parts (``TPLayout.state``), and this is one of them."""
    w = (cfg.lru_width or cfg.d_model) // parts
    return {"h": torch.zeros((B, w), dtype=dtype, device=device),
            "conv": torch.zeros((B, cfg.conv1d_width - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig,
                 cut: bool = False, ws: Tuple[str, ...] = ()
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: (B, d) → (output (B, d), the next state).  ``cut``:
    the rank's channels of the weights and the state (module docstring);
    ``ws`` (``TPLayout.act_embed``): ``x`` and the output are the rank's
    columns of ``embed``, and ``wx``/``wy``/``wout`` its slices of it
    (``layers.ws_pieces``): the two input products' f32 partials are
    summed over those axes in one call (``layers.ws_contract``)."""
    if ws:
        from repro_torch.models.layers import ws_contract
        xb, yb = ws_contract(x, [p["wx"], p["wy"]], ws)  # (B, w)
    else:
        xb, yb = x @ p["wx"], x @ p["wy"]
    hist = torch.cat([state["conv"], xb[:, None]], dim=1)  # (B, cw, w)
    xc = torch.einsum("bcw,cw->bw", hist, p["conv"]) + p["conv_b"]
    log_a, gated = _gates(p, xc, cut)
    h = state["h"] * torch.exp(log_a).to(x.dtype) + gated
    y = F.gelu(yb, approximate="tanh")
    return _out(p, h * y, cut), {"h": h, "conv": hist[:, 1:]}
