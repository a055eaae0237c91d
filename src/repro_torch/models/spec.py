"""Parameter specs and their initialisation (port of ``repro.models.spec``).

Model builders describe parameters as a tree (dicts and lists) of
``ParamSpec`` leaves; ``materialize`` draws them with the JAX package's
scheme — N(0, 0.02²) by default, ones/zeros for norms, ``small_normal``
scaled by 1/sqrt(fan-in), ``a_log`` the RG-LRU's Λ — from an explicit
``torch.Generator`` on the target device.  The draws differ from JAX's
(different generators); the parity tests convert the JAX weights instead
(``models.convert``).  ``abstract`` gives the same tree as tensors on the
``meta`` device: shapes and dtypes, no memory.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small_normal | a_log
    scale: float = 0.02


def _make(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    if spec.init == "a_log":  # RG-LRU Λ init: a = σ(Λ) in [0.9, 0.999]
        u = torch.rand(spec.shape, generator=gen, device=device,
                       dtype=torch.float32) * (0.999 - 0.9) + 0.9
        return torch.log(u / (1 - u)).to(dtype)
    scale = spec.scale
    if spec.init == "small_normal":
        scale = spec.scale / math.sqrt(max(spec.shape[-1], 1))
    x = torch.randn(spec.shape, generator=gen, device=device,
                    dtype=torch.float32)
    return x.mul_(scale).to(dtype)


def materialize(spec_tree, gen: torch.Generator, dtype=torch.float32,
                device=None):
    """Initialise every ``ParamSpec`` leaf of a dict/list tree, in sorted
    key order so the draws are reproducible from the generator's seed."""
    device = device if device is not None else gen.device
    if isinstance(spec_tree, ParamSpec):
        return _make(spec_tree, gen, dtype, device)
    if isinstance(spec_tree, dict):
        return {k: materialize(spec_tree[k], gen, dtype, device)
                for k in sorted(spec_tree)}
    return [materialize(s, gen, dtype, device) for s in spec_tree]


def abstract(spec_tree, dtype=torch.float32):
    """Every ``ParamSpec`` leaf as an empty tensor of its shape on the
    ``meta`` device (the JAX ``abstract``: stand-ins, nothing allocated)."""
    if isinstance(spec_tree, ParamSpec):
        return torch.empty(spec_tree.shape, dtype=dtype, device="meta")
    if isinstance(spec_tree, dict):
        return {k: abstract(v, dtype) for k, v in spec_tree.items()}
    return [abstract(s, dtype) for s in spec_tree]
