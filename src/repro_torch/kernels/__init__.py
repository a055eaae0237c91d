"""Hand-written CUDA kernels for the paper's attention hot spots.

paged_attention/ — split-K paged decode (K1) and its combine (K2);
flex_attention/  — block-sparse flash prefill with FlexAttention mods (K4).

Each kernel has a wrapper that checks its inputs and counts its launches,
and a plain PyTorch version of the same function in the same module.  The
wrapper takes the plain version only for CPU tensors (the CPU tests); on
CUDA tensors it launches the kernel or raises — it never falls back.
The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``, built
on first use by ``kernels.build``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.errors import EngineConfigError


IMPLS = ("kernel", "ref")


def check_impl(impl: str) -> None:
    """Raise ``EngineConfigError`` unless ``impl`` is "kernel" (the hand
    written kernels; the default) or "ref" (the plain oracles)."""
    if impl not in IMPLS:
        raise EngineConfigError(f"impl must be one of {IMPLS}, got "
                                f"{impl!r}", impl=impl)


def use_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True when ``tensors`` live on one CUDA device (launch the kernel),
    False when they all live on the CPU (run the plain version).  Anything
    else — mixed devices, another device type — raises."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise EngineConfigError(f"{name}: tensors on several devices "
                                f"{sorted(map(str, devices))}", kernel=name)
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise EngineConfigError(f"{name}: unsupported device {dev}",
                            kernel=name, device=str(dev))


def launch_wrappers():
    """The kernel wrappers of the main path, by kernel name."""
    from repro_torch.kernels.flex_attention.flex_attention import (
        flex_attention_kernel)
    from repro_torch.kernels.paged_attention.paged_attention import (
        combine_partials_kernel, paged_attention_partials)
    return {"paged_decode": paged_attention_partials,
            "combine": combine_partials_kernel,
            "flex_prefill": flex_attention_kernel}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {k: fn.launches for k, fn in launch_wrappers().items()}


def reset_launch_counts() -> None:
    for fn in launch_wrappers().values():
        fn.launches = 0
