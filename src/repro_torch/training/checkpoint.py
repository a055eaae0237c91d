"""Checkpointing: flat-key .npz save/restore of any tree of tensors (port
of ``repro.training.checkpoint``).

Keys are slash-joined tree paths (``utils.tree.tree_paths``: a
``TrainState`` saves ``params/...``, ``opt/mu/...``, ``opt/nu/...``,
``opt/count`` and ``step``); restore reconstructs into a target tree, so
structure, dtypes and devices come from the model, not the file.  No
pickle.  bf16 leaves are stored as f32 (numpy has no bf16), which
round-trips exactly.
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from repro_torch.utils.tree import to_numpy, tree_paths, tree_unflatten


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{name: to_numpy(leaf)
                      for name, leaf in tree_paths(tree)})


def restore(path: str, target: Any) -> Any:
    """Load into the structure of ``target`` (a tree of tensors: each leaf
    gives the shape, dtype and device).  Raises ``KeyError`` for a key the file lacks and ``ValueError`` for a
    shape that differs, as the JAX package's does."""
    with np.load(path) as data:
        flat = dict(data)
    out = []
    for name, ref in tree_paths(target):
        if name not in flat:
            raise KeyError(f"checkpoint missing {name!r}")
        a = flat[name]
        if tuple(a.shape) != tuple(ref.shape):
            raise ValueError(f"{name}: shape {a.shape} != expected "
                             f"{tuple(ref.shape)}")
        out.append(torch.as_tensor(a).to(dtype=ref.dtype, device=ref.device))
    return tree_unflatten(target, out)
