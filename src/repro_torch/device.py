"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: the
default is ``"cuda"``, and asking for CUDA on a host without a CUDA
device raises a structured error instead of silently running elsewhere.
"""

from __future__ import annotations

from typing import Union

import torch

from repro_torch.errors import EngineConfigError


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EngineConfigError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU",
            device=str(dev))
    return dev
