"""Hand-written CUDA kernels for the paper's attention hot spots.

paged_attention/ — split-K paged decode (K1), its combine (K2) and
                   chunked paged prefill (K3);
flex_attention/  — block-sparse flash prefill with FlexAttention mods (K4).

Each kernel has a wrapper that checks its inputs and counts its launches,
and a plain PyTorch version of the same function in the same module.  The
wrapper takes the plain version only for CPU tensors (the CPU tests); on
CUDA tensors it launches the kernel or raises — it never falls back.
The kernels are CUDA C++ for ``sm_90a`` under ``repro_torch/csrc``, built
on first use by ``kernels.build``.

Dry mode (``dry_mode``, entered only by the dry run, ``launch.steps.
dry_step``): on fake tensors (``utils.fake``) every wrapper takes its
kernel's route, with its checks and its allocations, and stops just
before the launch: it builds and launches nothing, and adds the kernel's
operations, bytes (its bound formula, beside the wrapper) and one launch
under its ``launch_counts()`` keys to a ``KernelTally``.  A pair the card
refuses is refused there too.  A real tensor never takes that route.
"""

from __future__ import annotations

import contextlib
import threading
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import torch

from repro_torch.errors import EngineConfigError, UnsupportedFeature
from repro_torch.utils.fake import is_fake


IMPLS = ("kernel", "ref")  # the serving entry points
# head dims of every route of K1, K3 and K4 (csrc/flash_tc.cuh: head_dim_ok)
HEAD_DIMS = (64, 128, 192, 256)
SMEM_LIMIT = 232_448  # dynamic shared memory of one H100 block, bytes
# the tensor-core tiles of K3 and K4 (csrc/flash_tc.cuh, flash_tf32.cuh):
# query rows per CTA and bytes per element, by tile
_TILES = {"tc": (128, 2), "tf32x3": (64, 4)}


def check_head_dim(kernel: str, D: int) -> None:
    """Raise ``UnsupportedFeature`` unless ``D`` is one of ``HEAD_DIMS``:
    what the wrappers check before a launch (the plain versions take any
    D); a pure function of D, so the CPU tests hold the card's refusals."""
    if D not in HEAD_DIMS:
        raise UnsupportedFeature(f"{kernel}: head_dim {D} is not taken "
                                 f"(takes {HEAD_DIMS})", head_dim=D)


def tile_keys(route: str, D: int) -> int:
    """Keys per K/V stage of a tensor-core tile at head dim ``D`` (route
    "tc" or "tf32x3", or one of their variants, "tc/int8" etc.): 128 and
    64 up to D = 128, 64 and 32 above, where the longer stages would not
    fit (``Layout<D>::kBN``)."""
    if route.split("/")[0] == "tc":
        return 128 if D <= 128 else 64
    return 64 if D <= 128 else 32


def tile_stages(route: str, D: int) -> int:
    """K/V stages in a tensor-core tile's ring (``Layout<D, I8>::kStages``):
    on the bf16 tile three, two at D = 256 (Q 64 KB + 2 x 64 KB) but three
    of int8; on the split-TF32 tile two, three of int8, and at D = 256,
    where Q hi + lo alone take 128 KB, one (two of int8)."""
    parts = route.split("/")
    int8 = "int8" in parts
    if parts[0] == "tc":
        return 3 if D <= 192 or int8 else 2
    if D <= 192:
        return 3 if int8 else 2
    return 2 if int8 else 1


def tile_smem_bytes(route: str, D: int) -> int:
    """Dynamic shared memory of a tensor-core tile's CTA, computed as
    ``Layout<D, I8>::kBytes`` computes it: the Q tile (hi and lo for
    "tf32x3", whose K lo tile follows on pools of q's dtype), the ring of
    K and V stages, 16 bytes of barriers per stage, and 1024 bytes of
    alignment slack.  On int8 pools (a route with "int8") the ring's stages
    hold int8 rows and one working stage of K and V in the tile's element
    type follows it."""
    tile = route.split("/")[0]
    rows, item = _TILES[tile]
    stages = tile_stages(route, D)
    q = rows * D * item
    work = tile_keys(tile, D) * D * item  # a K or V stage in the tile's type
    fixed = q if tile == "tc" else 2 * q
    if "int8" in route.split("/"):
        ring = 2 * stages * tile_keys(tile, D) * D
        return 1024 + fixed + ring + 2 * work + 16 * stages
    if tile == "tf32x3":
        fixed += work  # the K lo tile
    return 1024 + fixed + 2 * stages * work + 16 * stages


def check_impl(impl: str, allowed=IMPLS, entry: str = "serving") -> None:
    """Raise ``EngineConfigError`` unless ``impl`` is one of ``allowed``
    for the ``entry`` point: "kernel" (the hand written kernels) or "ref"
    (the plain oracles) everywhere, and "chunked" on the training path
    (``core.attention.TRAIN_IMPLS``)."""
    if impl not in allowed:
        raise EngineConfigError(f"{entry}: impl must be one of {allowed}, "
                                f"got {impl!r}", impl=impl)


@dataclass
class KernelTally:
    """What the kernels' stand-ins did in dry mode: launches under the
    ``launch_counts()`` keys, and the operations and bytes of their bound
    formulas (each launch's data-dependent work at its upper bound)."""
    launches: Counter = field(default_factory=Counter)
    flops: float = 0.0
    bytes: float = 0.0

    def add(self, keys: Sequence[str], flops: float, nbytes: float) -> None:
        for k in keys:
            self.launches[k] += 1
        self.flops += float(flops)
        self.bytes += float(nbytes)


class _Dry(threading.local):
    tally: Optional[KernelTally] = None


_DRY = _Dry()


@contextlib.contextmanager
def dry_mode(tally: KernelTally):
    """Within the block, wrappers given fake tensors stand in for their
    kernels and record into ``tally`` (see the module docstring)."""
    prev, _DRY.tally = _DRY.tally, tally
    try:
        yield tally
    finally:
        _DRY.tally = prev


def dry_tally(*tensors: torch.Tensor) -> Optional[KernelTally]:
    """The active tally when in dry mode and every tensor is fake, else
    None."""
    if _DRY.tally is not None and all(map(is_fake, tensors)):
        return _DRY.tally
    return None


def use_kernel(name: str, *tensors: torch.Tensor) -> bool:
    """True when ``tensors`` live on one CUDA device (launch the kernel),
    False when they all live on the CPU (run the plain version).  Anything
    else — mixed devices, another device type — raises.  In dry mode,
    fake tensors (on the CPU) take the kernel's route too: its wrapper
    then stands in for it (``dry_tally``)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise EngineConfigError(f"{name}: tensors on several devices "
                                f"{sorted(map(str, devices))}", kernel=name)
    dev = devices.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return dry_tally(*tensors) is not None
    raise EngineConfigError(f"{name}: unsupported device {dev}",
                            kernel=name, device=str(dev))


def tensor_core_p(p: torch.Tensor, terms=None) -> torch.Tensor:
    """The probabilities as the tensor-core kernels feed them to p.V: the
    sum of ``terms`` bf16 values (each rounding what the earlier ones left
    over), or ``p`` itself for None.  Used by the plain versions to show
    that the bf16 tolerance fits the kernels' arithmetic."""
    if not terms:
        return p
    out, rest = torch.zeros_like(p), p
    for _ in range(terms):
        part = rest.to(torch.bfloat16).float()
        out, rest = out + part, rest - part
    return out


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to nearest,
    ties away from zero, keeping 10 explicit mantissa bits (the low 13 bits
    of the f32 word become 0)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(op, a: torch.Tensor, b: torch.Tensor, terms=None
                 ) -> torch.Tensor:
    """``op(a, b)`` for a bilinear ``op`` (matmul, einsum) as the split-TF32
    kernels evaluate it: with hi = tf32(x) and lo = tf32(x - hi), ``terms``
    3 sums lo(a)·hi(b) + hi(a)·lo(b) + hi(a)·hi(b) (lo·lo dropped), 2 sums
    lo(a)·hi(b) + hi(a)·hi(b) (``b`` exact in TF32: the int8 pools' K and
    V), 1 takes hi(a)·hi(b) alone (one TF32 product), None is ``op(a, b)``
    itself.  Used by the plain versions to show that the f32 tolerance
    fits the kernels' arithmetic."""
    if not terms:
        return op(a, b)
    a_hi, b_hi = tf32(a), tf32(b)
    if terms == 1:
        return op(a_hi, b_hi)
    if terms not in (2, 3):
        raise ValueError(f"tf32 terms must be 1, 2 or 3, got {terms}")
    a_lo = tf32(a.float() - a_hi)
    if terms == 2:
        return op(a_lo, b_hi) + op(a_hi, b_hi)
    b_lo = tf32(b.float() - b_hi)
    return op(a_lo, b_hi) + op(a_hi, b_lo) + op(a_hi, b_hi)


def launch_wrappers():
    """The kernel wrappers of the main path, by kernel name."""
    from repro_torch.kernels.flex_attention.flex_attention import (
        flex_attention_kernel)
    from repro_torch.kernels.paged_attention.paged_attention import (
        combine_partials_kernel, paged_attention_partials,
        paged_prefill_partials)
    return {"paged_decode": paged_attention_partials,
            "combine": combine_partials_kernel,
            "paged_prefill": paged_prefill_partials,
            "flex_prefill": flex_attention_kernel}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset, per route of the
    wrappers that have several (K2's layouts: "combine/decode",
    "combine/prefill", "combine/dist" across ranks; "flex_prefill/tc",
    "flex_prefill/tf32x3"; K3's tiles by input: "paged_prefill/tc",
    "paged_prefill/tc/int8", "paged_prefill/tc/odd",
    "paged_prefill/tc/int8/odd" and the same of "tf32x3"), and per route
    and mask variant of K4 ("flex_prefill/tc/window&padding": only the
    variants launched since the reset)."""
    counts = {}
    for k, fn in launch_wrappers().items():
        counts[k] = fn.launches
        for route, n in getattr(fn, "launches_by_route", {}).items():
            counts[f"{k}/{route}"] = n
        for variant, n in getattr(fn, "launches_by_variant", {}).items():
            counts[f"{k}/{variant}"] = n
    return counts


def reset_launch_counts() -> None:
    for fn in launch_wrappers().values():
        fn.launches = 0
        routes = getattr(fn, "launches_by_route", {})
        for route in routes:
            routes[route] = 0
        getattr(fn, "launches_by_variant", {}).clear()
