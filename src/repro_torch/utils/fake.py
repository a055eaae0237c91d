"""Fake tensors (``torch._subclasses.FakeTensor``): shapes and dtypes
without data, made only by the dry run (``launch.steps.dry_step``).

The one test for them, and the two places where code of the port must
know it holds one: a branch that the card takes (``on_card``) and a count
read on the host (``count_true``).  A real tensor never takes either
fake branch.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def is_fake(t: torch.Tensor) -> bool:
    return isinstance(t, FakeTensor)


def on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor, and for a fake one: the dry run traces the
    card's path on fake "cpu" tensors."""
    return x.is_cuda or is_fake(x)


def count_true(mask: torch.Tensor) -> int:
    """``int(mask.sum())``, read on the host; for a fake tensor (no data
    to read) its upper bound, ``mask.numel()``."""
    if is_fake(mask):
        return mask.numel()
    return int(mask.sum())
