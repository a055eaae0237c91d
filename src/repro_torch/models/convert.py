"""Weights of the JAX package → the port's parameter dicts.

``params_from_numpy(tree, device, dtype)`` takes the JAX params as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's params on ``device`` (the card unless the caller passes
``device="cpu"``, as for every entry point): the same layouts, with the scanned pattern groups
(``groups/0A`` stacked ``(n_groups, ...)``) unstacked into one dict per
layer under ``layers``.  The port needs no JAX for this: it reads plain
nested dicts of arrays.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.errors import UnsupportedFeature


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
    groups = tree.get("groups", {})
    rem = tree.get("rem", {})
    codes = {key[1:] for key in list(groups) + list(rem)}
    if codes - {"A"}:
        raise UnsupportedFeature(f"layer codes {sorted(codes)}: the port "
                                 "converts all-'A' dense models only")
    per_layer = []
    units = sorted(groups, key=lambda k: int(k[:-1]))
    n_groups = (np.asarray(groups[units[0]]["ln1"]["scale"]).shape[0]
                if units else 0)
    for g in range(n_groups):
        for key in units:
            per_layer.append(_to_torch(groups[key], device, dtype, index=g))
    for key in sorted(rem, key=lambda k: int(k[:-1])):
        per_layer.append(_to_torch(rem[key], device, dtype))
    return {"embed": _to_torch(tree["embed"], device, dtype),
            "ln_f": _to_torch(tree["ln_f"], device, dtype),
            "layers": per_layer}
