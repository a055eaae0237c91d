"""Train state: params + optimizer state + step, as one tree (port of
``repro.training.state``)."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.training.optimizer import AdamWState, adamw_init


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    step: torch.Tensor  # () int32

    @classmethod
    def create(cls, params) -> "TrainState":
        opt = adamw_init(params)
        return cls(params=params, opt=opt,
                   step=torch.zeros((), dtype=torch.int32,
                                    device=opt.count.device))
