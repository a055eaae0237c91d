"""Meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` names the axes of a grid of ranks, ("data", "model") by
default, and knows this rank's coordinates and one process group per set
of axes (the ranks that differ only along those axes).  Ranks are laid
out row-major: the last axis varies fastest.  An axis, or set of axes, of
size 1 has no group and every collective over it is the identity, so a
1 x 1 mesh (``make_local_mesh``) needs no process group at all.

The caller starts the process group (``torch.distributed.
init_process_group`` with its own address, world size and rank: nothing
on the machine describes a cluster); ``make_mesh`` then builds the mesh
over it.  Every rank must build the same meshes in the same order
(``new_group`` is collective).

``make_production_mesh`` is the JAX package's production mesh over
``torch.distributed``: (16, 16) over ("data", "model"), or (2, 16, 16)
over ("pod", "data", "model"), so that plans match the JAX ones at
production size.  The constants below are the H100's (the JAX ones are a
TPU v5e's); the roofline bounds, the dry run's fits-proof and ``PERF.md``
use them.

A dry mesh (``make_dry_mesh``, ``make_production_mesh(dry=True)``) has
the same axes and one rank's coordinates but no process group: its
``group`` gives a ``distributed.sharding.DryGroup`` (the member ranks),
over which the collectives of ``distributed.collectives`` return tensors
of the real result's shape without communicating and record what they
would send (``launch.dryrun``).
"""

from __future__ import annotations

import itertools
import math
from collections import Counter
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.distributed.sharding import DryGroup
from repro_torch.errors import DistributedSetupError

# NVIDIA H100 SXM5 80GB ("NVIDIA H100 80GB HBM3, 700.00 W"), per GPU, from
# NVIDIA's H100 Tensor Core GPU datasheet (SXM5 column)
PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12  # bytes/s, HBM3
# NVLink 4: 18 links of 50 GB/s, both directions together (the
# datasheet's 900 GB/s); the counterpart of the JAX package's ICI_BW
NVLINK_BW = 900e9  # bytes/s per GPU
HBM_BYTES = 80e9  # device memory per GPU (the datasheet's 80 GB)
# an HGX/DGX H100 node: 8 GPUs on one NVLink switch (NVIDIA DGX H100
# datasheet); beyond the node each GPU has one 400 Gb/s ConnectX-7 NIC,
# 50e9 bytes/s each way (the same datasheet's networking row)
NODE_GPUS = 8
NET_BW = 50e9  # bytes/s per GPU, each direction


class Mesh:
    """A named grid of ranks: ``axis_names``, ``shape``, this rank's
    ``coords``, process groups by axis set (``group``) and the record of
    the collectives run over them."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Sequence[str] = ("data", "model"),
                 rank: int = 0, groups: Optional[Dict] = None):
        if len(shape) != len(axis_names):
            raise DistributedSetupError(
                f"mesh shape {tuple(shape)} does not match axes "
                f"{tuple(axis_names)}")
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names)
        self.rank = rank
        self.coords = _unravel(rank, self.shape)
        self._groups = groups or {}
        # the collectives' record (``distributed.collectives``): the ops a
        # gloo group refused on CUDA tensors (None until probed), the
        # calls copied through host memory, and per op the calls, bytes
        # sent and host seconds
        self.host_ops: Optional[set] = None
        self.host_copies: Counter = Counter()
        self.stats = {"calls": Counter(), "bytes": Counter(),
                      "seconds": Counter()}

    def size(self, name: str) -> int:
        if name not in self.axis_names:
            raise DistributedSetupError(f"mesh has no axis {name!r}",
                                        axis=name)
        return self.shape[self.axis_names.index(name)]

    def index(self, name: str) -> int:
        """This rank's coordinate along axis ``name``."""
        return self.coords[self.axis_names.index(name)] if (
            name in self.axis_names) else 0

    def flat_index(self, axes: Sequence[str]) -> int:
        """This rank's row-major index over ``axes`` (mixed radix)."""
        idx = 0
        for a in axes:
            idx = idx * self.size(a) + self.index(a)
        return idx

    def prod(self, axes: Sequence[str]) -> int:
        return math.prod(self.size(a) for a in axes)

    def group(self, axes: Sequence[str]):
        """The process group over ``axes`` (None when their product is
        1: nothing to communicate)."""
        key = tuple(a for a in self.axis_names if a in tuple(axes))
        if self.prod(key) == 1:
            return None
        if key not in self._groups:
            raise DistributedSetupError(
                f"mesh has no process group over {key}", axes=key)
        return self._groups[key]

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.shape))}, "
                f"rank={self.rank}, coords={self.coords})")


def _unravel(rank: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    out = []
    for s in reversed(shape):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


def make_mesh(shape: Sequence[int],
              axis_names: Sequence[str] = ("data", "model")) -> Mesh:
    """A mesh of ``shape`` over the default process group, whose size
    must be ``prod(shape)``.  Creates one group per set of axes with more
    than one rank (collective: every rank calls this in the same order)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        raise DistributedSetupError(
            "make_mesh needs torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise DistributedSetupError(
            f"mesh {shape} needs {math.prod(shape)} ranks, the group has "
            f"{world}", world=world)
    names = tuple(axis_names)
    groups = {}
    for key, members in _axis_groups(shape):
        if len(key) == len(names):
            groups[names] = dist.group.WORLD
            continue
        g = dist.new_group(members)
        if rank in members:
            groups[tuple(names[i] for i in key)] = g
    return Mesh(shape, names, rank, groups)


def _axis_groups(shape: Tuple[int, ...]):
    """(axis indices, member ranks) of every group of ranks that share the
    coordinates off a set of axes of more than one rank, in the order
    ``make_mesh`` creates them."""
    coords = [_unravel(r, shape) for r in range(math.prod(shape))]
    for n in range(1, len(shape) + 1):
        for key in itertools.combinations(range(len(shape)), n):
            if math.prod(shape[i] for i in key) == 1:
                continue
            buckets: Dict[Tuple, list] = {}
            for r, c in enumerate(coords):
                rest = tuple(c[i] for i in range(len(shape)) if i not in key)
                buckets.setdefault(rest, []).append(r)
            for members in buckets.values():
                yield key, members


def make_dry_mesh(shape: Sequence[int],
                  axis_names: Sequence[str] = ("data", "model"),
                  rank: int = 0) -> Mesh:
    """A mesh of ``shape`` seen from ``rank``, with no process group: every
    set of axes of more than one rank has a ``DryGroup`` of the ranks
    that share this rank's other coordinates.  Its ``stats`` also hold
    ``"ops"``: per collective, (op, bytes sent, group size, member
    ranks)."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names)
    if not 0 <= rank < math.prod(shape):
        raise DistributedSetupError(f"rank {rank} is not on mesh {shape}",
                                    rank=rank)
    groups = {tuple(names[i] for i in key): DryGroup(len(members),
                                                     tuple(members))
              for key, members in _axis_groups(shape) if rank in members}
    mesh = Mesh(shape, names, rank, groups)
    mesh.stats["ops"] = []
    return mesh


def make_production_mesh(*, multi_pod: bool = False, dry: bool = False,
                         rank: int = 0) -> Mesh:
    """The production mesh over the default process group: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model") with
    ``multi_pod`` (the "pod" axis carries pure data parallelism).  A group
    of another size raises ``DistributedSetupError``.  With ``dry`` the
    same mesh seen from ``rank`` without any process group
    (``make_dry_mesh``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if dry:
        return make_dry_mesh(shape, axes, rank)
    return make_mesh(shape, axes)


def make_local_mesh() -> Mesh:
    """The 1 x 1 mesh with the production axis names (one rank, no
    process group)."""
    return Mesh((1, 1), ("data", "model"))
