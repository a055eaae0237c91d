"""Cost, memory and roofline terms of one traced step (the port's
counterpart of ``repro.launch.hlo_analysis``).

The JAX module parses the compiled HLO: the collectives GSPMD inserted,
XLA's ``cost_analysis`` and ``memory_analysis``.  The port compiles
nothing and its collectives are explicit calls (``distributed.
collectives``), so it reads no HLO: ``record_step`` runs the step once
and counts where things happen —

  * FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the aten ops,
    plus the kernels' stand-ins' operations (``kernels.KernelTally``);
  * bytes, the counterpart of XLA's "bytes accessed": the inputs' and
    outputs' bytes of every dispatched op that moves data (views, and
    allocations that write nothing, excluded), plus the stand-ins';
  * memory: ``StorageTracker``, a ``TorchDispatchMode`` that follows each
    new storage until it is freed (the live total's peak);
  * collectives: what each helper records in the mesh's ``stats``.

On fake tensors (``launch.steps.dry_step``) a data-dependent size is an
unbacked symbol of the trace's ``ShapeEnv``; every count takes its upper
bound, so the fits-proof may only err high.

No counterpart of two JAX pieces: ``f32_shadow_bytes`` (an XLA:CPU
artifact, its bf16 buffers widened to f32: a fake trace keeps the card's
dtypes) and the L1/L2 scan correction (XLA counts a ``while`` body once;
an eager trace runs every layer, so the counts are whole).

Roofline terms use the H100's datasheet constants (``launch.mesh``).
Collective bytes are per device and per direction: what one GPU sends,
which in a ring it also receives.  They go at NVLink's 450 GB/s each way
(``NVLINK_BW / 2``) within a node and at the NIC's ``NET_BW`` beyond it;
a group whose ranks span nodes runs at the slower link for all its bytes
(a ring is as fast as its slowest hop).
"""

from __future__ import annotations

import math
import time
import weakref
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import KernelTally
from repro_torch.launch.mesh import (HBM_BW, NET_BW, NODE_GPUS, NVLINK_BW,
                                     PEAK_FLOPS_BF16)
from repro_torch.utils.tree import tree_leaves

# the port's collective ops by the JAX module's kinds
KINDS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
         "reduce_scatter": "reduce-scatter", "all_to_all": "all-to-all",
         "send_recv": "collective-permute"}
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}
_DEVICE = torch.ops.prim.device.default  # a metadata query, no data


def upper(n) -> int:
    """``n`` as an int; a symbolic size at its upper bound."""
    if isinstance(n, (torch.SymInt, torch.SymFloat)):
        node = n.node
        return int(node.shape_env.bound_sympy(node.expr).upper)
    return int(n)


def _nbytes(t: torch.Tensor) -> int:
    return upper(t.numel()) * t.element_size()


class StorageTracker(TorchDispatchMode):
    """Follows every storage the dispatched ops create until it is freed:
    ``live`` bytes, their ``peak``, and ``moved``, the inputs' and outputs'
    bytes of every op that moves data.  ``arguments`` registers the
    step's inputs first (live from the start); ``finish`` takes its
    outputs and stops the count."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.moved = 0
        self.argument_bytes = self.output_bytes = 0
        self._sizes: Dict[int, int] = {}
        self._args: set = set()
        self._on = True

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = upper(st.nbytes())
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        if self._on:
            self.live -= self._sizes.pop(key)

    def arguments(self, args) -> None:
        for t in tree_leaves(args):
            if isinstance(t, torch.Tensor):
                self._track(t)
                self._args.add(id(t.untyped_storage()))
        self.argument_bytes = self.live

    def finish(self, outputs) -> None:
        seen = set()
        for t in tree_leaves(outputs):
            if isinstance(t, torch.Tensor):
                key = id(t.untyped_storage())
                if key not in self._args and key not in seen:
                    seen.add(key)
                    self.output_bytes += self._sizes.get(key, 0)
        self._on = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._on or func is _DEVICE:
            return out
        ins = _tensors(args) + _tensors(kwargs.values())
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,))
        for t in outs:
            self._track(t)
        if func.is_view or func.overloadpacket.__name__ in _ALLOCS:
            return out
        if outs and not func._schema.is_mutable:
            in_st = {id(t.untyped_storage()) for t in ins}
            if all(id(t.untyped_storage()) in in_st for t in outs):
                return out  # a new view of an input (``_unsafe_view``)
        self.moved += sum(_nbytes(t) for t in ins + outs)
        return out


def _tensors(xs) -> list:
    """The tensors among ``xs`` and in its lists and tuples (an op's
    arguments and results)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out += [t for t in x if isinstance(t, torch.Tensor)]
    return out


@dataclass
class StepRecord:
    """What ``record_step`` counted over one step."""
    flops: float  # FlopCounterMode over the aten ops
    bytes: float  # inputs + outputs of the ops that move data
    kernels: KernelTally  # the stand-ins' launches, operations and bytes
    argument_bytes: int  # the storages of the step's inputs
    output_bytes: int  # the new storages it returns
    peak_bytes: int  # the largest live total during the step
    stats: Optional[Dict[str, Any]] = None  # the mesh's collective record
    seconds: float = 0.0


def record_step(step, args, mesh=None,
                tally: Optional[KernelTally] = None) -> StepRecord:
    """Run ``step(*args)`` once under ``FlopCounterMode`` and a
    ``StorageTracker`` (inside whatever modes the caller entered: the dry
    run's ``FakeTensorMode`` and ``kernels.dry_mode``).  ``mesh``: the
    mesh the step runs on, whose collective ``stats`` the record keeps
    (calls and bytes of this step only)."""
    from torch.utils.flop_counter import FlopCounterMode
    before = ({k: dict(v) for k, v in mesh.stats.items() if k != "ops"}
              if mesh is not None else None)
    n_ops = len(mesh.stats.get("ops", ())) if mesh is not None else 0
    tracker = StorageTracker()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc, tracker:
        tracker.arguments(args)
        out = step(*args)
        tracker.finish(out)
    seconds = time.perf_counter() - t0
    stats = None
    if mesh is not None:
        stats = {k: {op: n - before[k].get(op, 0) for op, n in v.items()
                     if n - before[k].get(op, 0)}
                 for k, v in mesh.stats.items() if k in ("calls", "bytes")}
        stats["ops"] = list(mesh.stats.get("ops", ()))[n_ops:]
    return StepRecord(flops=float(upper(fc.get_total_flops())),
                      bytes=float(tracker.moved),
                      kernels=tally if tally is not None else KernelTally(),
                      argument_bytes=tracker.argument_bytes,
                      output_bytes=tracker.output_bytes,
                      peak_bytes=tracker.peak, stats=stats, seconds=seconds)


def collective_bytes(stats: Dict[str, Any]) -> Dict[str, float]:
    """Per-device bytes sent over the links, by kind (the JAX module's
    names and ring factors) and by where they go, from a mesh's record of
    (op, bytes of the input, group size, member ranks):

      all-gather:         (g−1)/g of the output (g inputs)
      all-reduce:         2 · (g−1)/g of the input
      reduce-scatter:     in − out, (g−1)/g of the input
      all-to-all:         (g−1)/g of the input
      collective-permute: the input (one hop)

    ``within_node``: groups whose ranks share one node of ``NODE_GPUS``;
    ``beyond_node``: the rest."""
    out = dict.fromkeys(("all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute"), 0.0)
    within = beyond = 0.0
    for op, nbytes, g, ranks in stats.get("ops", ()):
        if g <= 1:
            continue
        kind = KINDS[op]
        sent = _sent(kind, nbytes, g)
        out[kind] += sent
        if len({r // NODE_GPUS for r in ranks}) == 1:
            within += sent
        else:
            beyond += sent
    out["total"] = sum(out.values())
    out["within_node"] = within
    out["beyond_node"] = beyond
    return out


def _sent(kind: str, nbytes: int, g: int) -> float:
    """The bytes one rank sends for a collective of ``kind`` on an input
    of ``nbytes`` over ``g`` ranks (``collective_bytes``' factors)."""
    if kind == "all-gather":
        return nbytes * g * (g - 1) / g
    if kind == "all-reduce":
        return 2 * nbytes * (g - 1) / g
    if kind in ("all-to-all", "reduce-scatter"):
        return nbytes * (g - 1) / g
    return float(nbytes)


def group_axes(mesh, ranks) -> Tuple[str, ...]:
    """The mesh axes a group of global ``ranks`` (row-major over
    ``mesh.shape``) spans: those along which its members' coordinates
    differ, in the mesh's order."""
    coords = [[(r // math.prod(mesh.shape[i + 1:])) % n
               for i, n in enumerate(mesh.shape)] for r in ranks]
    return tuple(a for i, a in enumerate(mesh.axis_names)
                 if len({c[i] for c in coords}) > 1)


def collective_bytes_by_axes(stats: Dict[str, Any], mesh
                             ) -> Dict[str, Dict[str, Dict[str, float]]]:
    """The record of ``collective_bytes`` by the mesh axes each group
    spans (``group_axes``, joined by ","): per kind, the ``calls``, the
    inputs' ``bytes`` and the ``sent`` bytes (``collective_bytes``'
    factors).  FSDP's weight gathers are the all-gathers over its axes
    ("data"), the kvp merge's those over the stripe axes."""
    out: Dict[str, Dict[str, Dict[str, float]]] = {}
    for op, nbytes, g, ranks in stats.get("ops", ()):
        if g <= 1:
            continue
        kind = KINDS[op]
        row = out.setdefault(",".join(group_axes(mesh, ranks)), {}
                             ).setdefault(kind, dict.fromkeys(
                                 ("calls", "bytes", "sent"), 0.0))
        row["calls"] += 1
        row["bytes"] += nbytes
        row["sent"] += _sent(kind, nbytes, g)
    return out


def extract_cost(record: StepRecord) -> Dict[str, float]:
    """The step's FLOPs and HBM bytes per device, the aten ops' and the
    kernels' stand-ins' together (and the stand-ins' alone)."""
    k = record.kernels
    return {"flops": record.flops + k.flops, "bytes": record.bytes + k.bytes,
            "kernel_flops": k.flops, "kernel_bytes": k.bytes}


def memory_stats(record: StepRecord) -> Dict[str, float]:
    """The JAX module's keys: the rank's inputs (``argument_bytes``), the
    new storages it returns (``output_bytes``), the rest of the peak
    (``temp_bytes``), ``alias_bytes`` 0 and ``peak_bytes``, the largest
    live total during the step."""
    arg, out, peak = (record.argument_bytes, record.output_bytes,
                      record.peak_bytes)
    return {"argument_bytes": float(arg), "output_bytes": float(out),
            "temp_bytes": float(peak - arg - out),
            "alias_bytes": 0.0,  # eager torch donates no input
            "peak_bytes": float(peak)}


def roofline_terms(flops: float, hbm_bytes: float,
                   coll: Dict[str, float]) -> Dict[str, Any]:
    """Per-device seconds of each roofline term (H100 constants): compute
    at the dense bf16 peak, memory at the HBM rate, collectives within a
    node at NVLink's rate each way and beyond it at the NIC's."""
    t: Dict[str, Any] = {
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": hbm_bytes / HBM_BW,
        "collective_s": (coll["within_node"] / (NVLINK_BW / 2)
                         + coll["beyond_node"] / NET_BW),
    }
    t["bottleneck"] = max(("compute_s", "memory_s", "collective_s"),
                          key=lambda k: t[k])
    return t


def model_flops(cfg, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); 2·N·D for the
    inference kinds (no backward)."""
    from repro_torch.models.api import build_model
    from repro_torch.utils.tree import count_params
    total = count_params(build_model(cfg).param_spec())
    if cfg.is_moe:
        # active = total − (inactive expert params)
        expert = 3 * cfg.d_model * cfg.expert_ff * cfg.n_layers
        active = total - cfg.n_experts * expert + cfg.top_k * expert
    else:
        active = total
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * n_tokens
