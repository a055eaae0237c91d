"""Weights of the JAX package → the port's parameter dicts.

``params_from_numpy(tree, device, dtype)`` takes the JAX params as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's params on ``device`` (the card unless the caller passes
``device="cpu"``, as for every entry point): the same layouts, with the
scanned pattern groups (``groups/0A``, ``groups/1W`` stacked
``(n_groups, ...)``; a ``W`` layer carries the same parameters as an
``A`` one, an ``R``, ``M`` or ``S`` layer a ``rec`` dict in place of
``attn``) unstacked into one dict per layer under ``layers``, in the
pattern's order.  An encoder-decoder's tree (``embed``, ``enc`` and
``dec`` stacked over their layers, ``ln_enc``, ``ln_f``) becomes lists of
one dict per layer under ``enc`` and ``dec``.  The port needs no JAX for
this: it reads plain nested dicts of arrays.

The way back: ``params_to_numpy(params, cfg)`` re-stacks the per-layer
lists into the JAX trees (``groups``/``rem``, or ``enc``/``dec``) as
numpy arrays, so the JAX package can load what the port trained; and
``train_state_from_numpy`` carries a whole JAX ``TrainState`` (params, the
AdamW moments ``mu``/``nu``, ``count`` and ``step``) into the port's
``training.TrainState``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.errors import UnsupportedFeature
from repro_torch.utils.tree import to_numpy, tree_map


def _to_torch(tree, device, dtype, index=None):
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, dtype, index) for k, v in tree.items()}
    arr = np.asarray(tree)
    if index is not None:
        arr = arr[index]
    return torch.tensor(arr, device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], device="cuda",
                      dtype=torch.float32) -> Dict[str, Any]:
    device = resolve_device(device)
    if "enc" in tree:  # the encoder-decoder
        out = {k: _to_torch(tree[k], device, dtype)
               for k in ("embed", "ln_enc", "ln_f")}
        for key in ("enc", "dec"):
            n = np.asarray(tree[key]["ln1"]["scale"]).shape[0]
            out[key] = [_to_torch(tree[key], device, dtype, index=i)
                        for i in range(n)]
        return out
    groups = tree.get("groups", {})
    rem = tree.get("rem", {})
    codes = {key[1:] for key in list(groups) + list(rem)}
    if codes - set("AWRCMS"):
        raise UnsupportedFeature(f"layer codes {sorted(codes)}: the port "
                                 "converts models of 'A', 'W', 'R', 'C', "
                                 "'M' and 'S' layers only")
    per_layer = []
    units = sorted(groups, key=lambda k: int(k[:-1]))
    n_groups = (np.asarray(groups[units[0]]["ln1"]["scale"]).shape[0]
                if units else 0)
    for g in range(n_groups):
        for key in units:
            per_layer.append(_to_torch(groups[key], device, dtype, index=g))
    for key in sorted(rem, key=lambda k: int(k[:-1])):
        per_layer.append(_to_torch(rem[key], device, dtype))
    out = {"embed": _to_torch(tree["embed"], device, dtype),
           "ln_f": _to_torch(tree["ln_f"], device, dtype),
           "layers": per_layer}
    if "vision_proj" in tree:
        out["vision_proj"] = _to_torch(tree["vision_proj"], device, dtype)
    return out


def _stack(layers):
    """One tree of arrays stacked along a new leading axis, from a list of
    trees of tensors."""
    return tree_map(lambda *xs: np.stack([to_numpy(x) for x in xs]),
                    *layers)


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig
                    ) -> Dict[str, Any]:
    """The port's params → the JAX package's tree of numpy arrays (bf16 as
    f32): the inverse of ``params_from_numpy``.  Layer ``g·U + j`` of a
    pattern unit of ``U`` codes goes to ``groups/{j}{code}[g]`` for the
    ``n_layers // U`` whole units, the rest to ``rem/{j}{code}``."""
    if "enc" in params:
        out = {k: tree_map(to_numpy, params[k])
               for k in ("embed", "ln_enc", "ln_f")}
        for key in ("enc", "dec"):
            out[key] = _stack(params[key])
        return out
    U = len(cfg.layer_pattern)
    per_layer = params["layers"]
    n = len(per_layer) // U * U  # the layers of whole units
    out = {k: tree_map(to_numpy, v) for k, v in params.items()
           if k != "layers"}
    out["groups"] = {f"{j}{c}": _stack(per_layer[j:n:U])
                     for j, c in enumerate(cfg.layer_pattern)} if n else {}
    out["rem"] = {f"{j}{c}": tree_map(to_numpy, per_layer[n + j])
                  for j, c in enumerate(cfg.pattern()[n:])}
    return out


def train_state_from_numpy(state, device="cuda", dtype=torch.float32):
    """A JAX ``TrainState`` as numpy (``jax.tree_util.tree_map(np.asarray,
    state)``: ``params``, ``opt.mu``, ``opt.nu``, ``opt.count``, ``step``)
    → the port's ``training.TrainState`` on ``device``: params and the
    moments through ``params_from_numpy``, ``count`` and ``step`` as int32
    scalars."""
    from repro_torch.training.optimizer import AdamWState
    from repro_torch.training.state import TrainState
    device = resolve_device(device)

    def scalar(x):
        return torch.tensor(np.asarray(x), dtype=torch.int32, device=device)

    return TrainState(
        params=params_from_numpy(state.params, device, dtype),
        opt=AdamWState(mu=params_from_numpy(state.opt.mu, device, dtype),
                       nu=params_from_numpy(state.opt.nu, device, dtype),
                       count=scalar(state.opt.count)),
        step=scalar(state.step))


def sharded_params_from_numpy(tree: Dict[str, Any], model, plan,
                              device="cuda", dtype=torch.float32
                              ) -> Dict[str, Any]:
    """This rank's pieces, under ``plan`` (``launch.steps.Plan``), of the
    JAX params as numpy (``model.shard_params`` of ``params_from_numpy``):
    every rank converts the same tree and keeps its own cut."""
    return model.shard_params(params_from_numpy(tree, device, dtype), plan)
