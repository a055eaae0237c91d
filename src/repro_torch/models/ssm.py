"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (port
of ``repro.models.ssm``).

mLSTM recurrence (heads h, key dim dk, value dim dv):
    C_t = f_t·C_{t-1} + i_t·(v_t k_tᵀ)      C: (h, dv, dk)
    n_t = f_t·n_{t-1} + i_t·k_t             n: (h, dk)
    y_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)
with an exponential input gate and a log-sigmoid forget gate, stabilised
by the running max m_t in log space.  Prefill uses the parallel quadratic
form (the decay matrix in log space, the row stabiliser ``max(m, 0)``, the
normaliser floored at ``exp(-m)``); decode the recurrence.

sLSTM is a true recurrence (h_{t-1} feeds the gates): a loop over time.

Neither block reaches a Pallas kernel in the JAX package (``einsum``s,
``cumsum`` and ``lax.scan``), so both stay plain PyTorch here.

A prefill also returns each row's decode state after its own last token,
``lens - 1`` (the JAX package takes it at the padded end, which differs for
the short rows of a padded wave): for mLSTM in closed form from the same
log-decay row, ``m = max_j logD[t, j]``, ``C = Σ_j e^{logD[t, j] - m} v_j
k_jᵀ`` and ``n = Σ_j e^{logD[t, j] - m} k_j`` — what the recurrence from
``m = -1e30`` reaches at step t; for sLSTM the states of the loop at that
step.  The recurrent accumulators are f32, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.spec import ParamSpec


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, cfg.d_model // H


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("...d,dhk->...hk") (or "...d,dh->...h") as one matmul."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1],
                                                   *w.shape[1:])


def _out(y: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("...hk,hkd->...d")."""
    H, dh, d = wo.shape
    return y.reshape(*y.shape[:-2], H * dh) @ wo.reshape(H * dh, d)


def _key_scale(dh: int, dtype) -> float:
    """sqrt(dh) rounded to the activations' dtype, as the JAX package
    divides k by ``jnp.sqrt(dh).astype(x.dtype)``."""
    return float(torch.tensor(math.sqrt(dh)).to(dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H, dh = _dims(cfg)
    return {
        "wq": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wk": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wv": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wi": ParamSpec((d, H), ("embed", "heads"), "small_normal"),
        "wf": ParamSpec((d, H), ("embed", "heads"), "small_normal"),
        "bf": ParamSpec((H,), ("heads",), "ones"),
        "wo": ParamSpec((H, dh, d), ("heads", None, "embed")),
        "ogate": ParamSpec((d, H, dh), ("embed", "heads", None)),
    }


def _mlstm_parts(p: Dict, x: torch.Tensor, cfg: ModelConfig):
    """q, k (scaled), v as (B, H, S, dh) in x's dtype; log i, log f and
    their cumulative sum F (B, H, S) in f32."""
    _, dh = _dims(cfg)
    q = _proj(x, p["wq"]).transpose(1, 2)
    k = (_proj(x, p["wk"]) / _key_scale(dh, x.dtype)).transpose(1, 2)
    v = _proj(x, p["wv"]).transpose(1, 2)
    logi = _proj(x, p["wi"]).float().transpose(1, 2)
    logf = F.logsigmoid(_proj(x, p["wf"]).float()
                        + p["bf"]).transpose(1, 2)
    return q, k, v, logi, torch.cumsum(logf, dim=-1)


def _mlstm_parallel(p: Dict, x: torch.Tensor, q, k, v, logi, Fc
                    ) -> torch.Tensor:
    """The parallel quadratic form over whole sequences → (B, S, d)."""
    S = x.shape[1]
    # D_ij = exp(Σ_{l=j+1..i} log f_l + log i_j), lower-triangular
    logD = Fc[..., :, None] - Fc[..., None, :] + logi[..., None, :]
    future = torch.ones((S, S), dtype=torch.bool,
                        device=x.device).triu_(1)
    # serving runs in place (two (B, H, S, S) f32 buffers at most); under
    # autograd (training) the same ops run out of place, so that every
    # input a backward saved stays as it was
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, logi, Fc))

    def op(t, name, *args):
        return getattr(t, name if grad else name + "_")(*args)

    logD = op(logD, "masked_fill", future, float("-inf"))
    m = torch.clamp(logD.amax(dim=-1, keepdim=True), min=0.0)
    D = op(op(logD, "sub", m), "exp")  # (B, H, S, S)
    s = op((q @ k.transpose(-1, -2)).float(), "mul", D)
    del logD, D
    n = torch.maximum(s.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
    w = op(s, "div", n).to(x.dtype)
    del s
    y = w @ v  # (B, H, S, dh)
    o = F.silu(_proj(x, p["ogate"]))  # (B, S, H, dh)
    return _out(y.transpose(1, 2) * o, p["wo"])


def mlstm_train(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Parallel (quadratic) form.  x: (B, S, d) → (B, S, d)."""
    return _mlstm_parallel(p, x, *_mlstm_parts(p, x, cfg))


def mlstm_prefill(p: Dict, x: torch.Tensor, lens: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, d) right-padded prompts of ``lens`` tokens → (the block's
    output (B, S, d), the decode state ``(C, n, m)`` after each row's token
    ``lens - 1``, in closed form from the log-decay row there)."""
    q, k, v, logi, Fc = _mlstm_parts(p, x, cfg)
    return (_mlstm_parallel(p, x, q, k, v, logi, Fc),
            _mlstm_last_state(k, v, logi, Fc, lens))


def _mlstm_last_state(k, v, logi, Fc, lens: torch.Tensor) -> Dict:
    """``(C, n, m)`` after each row's token t = ``lens - 1``, from the
    log-decay row ``logD[t, j] = F_t - F_j + log i_j`` (j <= t)."""
    S = k.shape[2]
    last = torch.clamp(lens.long() - 1, min=0)
    Ft = Fc.gather(-1, last[:, None, None].expand(-1, Fc.shape[1], 1))
    logw = Ft - Fc + logi  # (B, H, S)
    past = torch.arange(S, device=k.device)[None, None] > last[:, None, None]
    logw.masked_fill_(past, float("-inf"))
    m = logw.amax(dim=-1)  # (B, H)
    w = torch.exp(logw - m[..., None])
    kf = k.float()
    C = (v.float() * w[..., None]).transpose(-1, -2) @ kf  # (B, H, dv, dk)
    n = (w[..., None] * kf).sum(dim=-2)
    return {"C": C, "n": n, "m": m}


def mlstm_init_state(B: int, cfg: ModelConfig, dtype=torch.float32,
                     device=None) -> Dict:
    """Zeros, ``m = -1e30``; always f32 (the stabilised recurrence
    multiplies by f32 gate factors every step)."""
    del dtype
    H, dh = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((B, H, dh, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "m": torch.full((B, H), -1e30, **f32)}


def mlstm_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: (B, d) → (output (B, d), the next state)."""
    _, dh = _dims(cfg)
    q = _proj(x, p["wq"])  # (B, H, dh)
    k = _proj(x, p["wk"]) / _key_scale(dh, x.dtype)
    v = _proj(x, p["wv"])
    logi = _proj(x, p["wi"]).float()  # (B, H)
    logf = F.logsigmoid(_proj(x, p["wf"]).float() + p["bf"])
    m_new = torch.maximum(logf + state["m"], logi)
    fe = torch.exp(logf + state["m"] - m_new)[..., None]
    ie = torch.exp(logi - m_new)[..., None]
    C = state["C"] * fe[..., None] + ie[..., None] * (
        v[..., :, None] * k[..., None, :]).float()
    n = state["n"] * fe + ie * k.float()
    qf = q.float()
    qdot = (n * qf).sum(dim=-1)
    denom = torch.maximum(qdot.abs(), torch.exp(-m_new))[..., None]
    y = (C @ qf[..., None])[..., 0] / denom
    o = F.silu(_proj(x, p["ogate"]))
    return _out((y * o).to(x.dtype), p["wo"]), {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_spec(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    H, dh = _dims(cfg)
    return {
        "wz": ParamSpec((d, H, dh), ("embed", "heads", None)),
        "wi": ParamSpec((d, H, dh), ("embed", "heads", None), "small_normal"),
        "wf": ParamSpec((d, H, dh), ("embed", "heads", None), "small_normal"),
        "wo_gate": ParamSpec((d, H, dh), ("embed", "heads", None)),
        # recurrent (block-diagonal per head) connections h_{t-1} → gates
        "rz": ParamSpec((H, dh, dh), ("heads", None, None), "small_normal"),
        "ri": ParamSpec((H, dh, dh), ("heads", None, None), "small_normal"),
        "rf": ParamSpec((H, dh, dh), ("heads", None, None), "small_normal"),
        "bf": ParamSpec((H, dh), ("heads", None), "ones"),
        "wo": ParamSpec((H, dh, d), ("heads", None, "embed")),
    }


def slstm_init_state(B: int, cfg: ModelConfig, dtype=torch.float32,
                     device=None) -> Dict:
    """Zeros (``h`` in the activations' dtype, the accumulators in f32),
    ``m = -1e30``."""
    H, dh = _dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((B, H, dh), **f32),
            "n": torch.zeros((B, H, dh), **f32),
            "h": torch.zeros((B, H, dh), dtype=dtype, device=device),
            "m": torch.full((B, H, dh), -1e30, **f32)}


def _rec(h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """einsum("bhk,hkj->bhj") per head."""
    return (h.transpose(0, 1) @ r).transpose(0, 1)


def _slstm_cell(p: Dict, state: Dict, zx, ix, fx, ox) -> Dict:
    """One step from the pre-projected (B, H, dh) inputs."""
    h_prev = state["h"]
    z = torch.tanh(zx + _rec(h_prev, p["rz"]))
    logi = (ix + _rec(h_prev, p["ri"])).float()
    logf = F.logsigmoid((fx + _rec(h_prev, p["rf"])).float() + p["bf"])
    o = torch.sigmoid(ox)
    m_new = torch.maximum(logf + state["m"], logi)
    fe = torch.exp(logf + state["m"] - m_new)
    ie = torch.exp(logi - m_new)
    c = state["c"] * fe + ie * z.float()
    n = state["n"] * fe + ie
    h = o * (c / torch.clamp(n, min=1e-6)).to(z.dtype)
    return {"c": c, "n": n, "h": h, "m": m_new}


def _slstm_inputs(p: Dict, x: torch.Tensor):
    return [_proj(x, p[w]) for w in ("wz", "wi", "wf", "wo_gate")]


def slstm_prefill(p: Dict, x: torch.Tensor, lens: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """The recurrence over time.  x: (B, S, d) right-padded prompts of
    ``lens`` tokens → (the block's output (B, S, d), the state after each
    row's token ``lens - 1``)."""
    state = slstm_init_state(x.shape[0], cfg, x.dtype, x.device)
    hs, final = _slstm_scan(p, state, _slstm_inputs(p, x), lens)
    return _out(hs, p["wo"]), final


def _slstm_scan(p: Dict, state: Dict, inputs, lens: torch.Tensor):
    """The cell over time from ``state``: (h at every step (B, S, H, dh),
    the state after each row's step ``lens - 1``)."""
    B, S = inputs[0].shape[:2]
    seq = []
    for t in range(S):
        state = _slstm_cell(p, state, *(a[:, t] for a in inputs))
        seq.append(state)
    stacked = {k: torch.stack([s[k] for s in seq], dim=1) for k in state}
    rows = torch.arange(B, device=lens.device)
    last = torch.clamp(lens.long() - 1, min=0)
    return stacked["h"], {k: v[rows, last] for k, v in stacked.items()}


def slstm_train(p: Dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Sequential scan over time (true recurrence).  x: (B, S, d)."""
    lens = torch.full((x.shape[0],), x.shape[1], device=x.device)
    return slstm_prefill(p, x, lens, cfg)[0]


def slstm_decode(p: Dict, x: torch.Tensor, state: Dict, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """One step.  x: (B, d) → (output (B, d), the next state)."""
    state = _slstm_cell(p, state, *_slstm_inputs(p, x))
    return _out(state["h"], p["wo"]), state
