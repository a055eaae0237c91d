"""Parameter specs and their initialisation (port of ``repro.models.spec``).

Model builders describe parameters as a tree (dicts and lists) of
``ParamSpec`` leaves; ``materialize`` draws them with the JAX package's
scheme — N(0, 0.02²) by default, ones/zeros for norms, ``small_normal``
scaled by 1/sqrt(fan-in) — from an explicit ``torch.Generator`` on the
target device.  The draws differ from JAX's (different generators); the
parity tests convert the JAX weights instead (``models.convert``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: float = 0.02


def _make(spec: ParamSpec, gen: torch.Generator, dtype, device):
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
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
