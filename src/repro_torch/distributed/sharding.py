"""Logical-axis sharding rules (port of ``repro.distributed.sharding``).

Model code names tensor dims with *logical* axes ("batch", "heads",
"embed", ...).  A rule table maps each logical axis to zero or more
physical mesh axes, and ``logical_spec`` resolves a tuple of logical axes
to a ``PartitionSpec`` exactly as the JAX package does: mesh axes the
mesh lacks are dropped, a mesh axis shards at most one dim (the first
logical axis wins), and a dim the mesh axes do not divide is replicated.

The port runs eagerly, one process per rank: a tensor a rank holds is
already its shard.  ``shard_params`` cuts a full parameter tree to this
rank's pieces by each ``ParamSpec.axes``; ``logical_shard`` (a sharding
constraint under ``jit`` in the JAX package) is the identity here.  The
mesh is ``launch.mesh.Mesh``: axis names, shape, this rank's coordinates
and one process group per set of axes.

Example
-------
    rules = AxisRules({"batch": ("pod", "data"), "heads": "model"})
    with use_mesh(mesh, rules):
        spec = logical_spec(("batch", None, "heads"), shape=x.shape)
"""

from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass, field
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch.errors import DistributedSetupError

PhysAxes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """A resolved spec: per dim None, one mesh axis name or a tuple of
    them, trailing Nones dropped (``jax.sharding.PartitionSpec``'s
    entries)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _norm(v: PhysAxes) -> Optional[Tuple[str, ...]]:
    if v is None:
        return None
    if isinstance(v, str):
        return (v,)
    return tuple(v)


@dataclass(frozen=True)
class AxisRules:
    """Mapping from logical axis name to physical mesh axes."""

    table: Mapping[str, PhysAxes] = field(default_factory=dict)

    def physical(self, logical: Optional[str]) -> Optional[Tuple[str, ...]]:
        if logical is None:
            return None
        return _norm(self.table.get(logical))

    def extend(self, **overrides: PhysAxes) -> "AxisRules":
        t = dict(self.table)
        t.update(overrides)
        return AxisRules(t)


# Rules for the production (pod, data, model) mesh.  Configs may override.
DEFAULT_RULES = AxisRules(
    {
        "batch": ("pod", "data"),
        "embed": None,        # ("data",) for FSDP on big models (configs)
        "heads": ("model",),
        "kv_heads": None,     # ("model",) when kv_heads % model == 0
        "mlp": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "kv_pages": ("pod", "data"),
        "seq": None,        # ("model",) under the sequence-parallel plans
        "attn_seq": None,   # q/k/v seq dim; ("model",) under the ring plan
        "act_embed": None,  # activations' model dim (not the weight "embed")
        "layers": None,
        "state": ("model",),  # recurrent state heads (SSM/RG-LRU)
        "frames": None,
    }
)


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = DEFAULT_RULES


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[AxisRules] = None):
    """Activate a mesh (``launch.mesh.Mesh``) and a rule table for the
    distributed paths of this thread."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = rules
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


@dataclass(frozen=True)
class DryGroup:
    """The stand-in of a process group on a dry mesh (``launch.mesh.
    make_dry_mesh``, a mesh with no process group): its size and its
    members' global ranks (row-major over the mesh).  Over it the
    collectives of ``distributed.collectives`` send nothing and record
    what they would send."""
    size: int
    ranks: Tuple[int, ...]


def current_rules() -> AxisRules:
    return _CTX.rules


def _mesh_axis_sizes(mesh) -> Mapping[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def axis_size(name: str) -> int:
    """Size of a named axis of the active mesh."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.axis_names:
        raise DistributedSetupError(
            f"axis_size({name!r}): no active mesh defines it", axis=name)
    return _mesh_axis_sizes(mesh)[name]


def axis_index(name: str) -> int:
    """This rank's coordinate along a named axis of the active mesh."""
    axis_size(name)  # raises without a mesh that defines it
    return current_mesh().index(name)


def batch_axes_for(global_batch: int, mesh) -> Tuple[str, ...]:
    """The batch axes of a plan (the JAX ``plan_for``'s law): as much of
    ("pod", "data") as ``global_batch`` divides, in that order."""
    sizes = _mesh_axis_sizes(mesh)
    axes: Tuple[str, ...] = ()
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and global_batch % (prod * sizes[a]) == 0:
            axes += (a,)
            prod *= sizes[a]
    return axes


@dataclass(frozen=True)
class TPLayout:
    """Which weights a rank holds only a piece of, decided once per plan
    (``launch.steps.plan_for``): over the mesh's "model" axis (Megatron
    style) and over the FSDP axes.  ``TransformerModel.shard_params``
    cuts by it and the model's layers gather, reduce or attend exactly
    where it says; nothing infers a cut from a weight's shape.  The
    default is one rank: nothing cut.

      * ``vocab``: ``embed["tok"]`` rows and ``embed["head"]`` columns —
        a masked lookup summed over "model", the logits gathered;
      * ``mlp``: ``wg``/``wu`` columns and ``wd`` rows of ``d_ff`` —
        ``wd``'s partial sums reduced in f32;
      * ``experts``: the MoE experts, E/m of them a rank (the router
        whole), and ``ep`` how a rank computes them (``moe()``): without
        it GSPMD's cut — the rank routes its own tokens, runs its experts
        over their rows of the ``(E, C)`` dispatch buffer and combines
        the choices it holds, the partial sums reduced over "model"
        (``models.moe``); with it (the config's ``moe_ep``) JAX's
        ``ep.apply_moe_ep`` — the tokens exchanged by all-to-all with the
        experts' owners (``distributed.ep``);
      * ``attn``, per layer: ``"heads"`` (tp: ``wq``/``wk``/``wv``/``wo``
        and the pools by kv heads), ``"groups"`` (dp: ``wq``/``wo`` by
        G/m heads of every kv group), ``"q_heads"`` (GSPMD's ``heads``
        rule: ``wq``/``wo`` by H/m contiguous heads, ``wk``/``wv`` whole)
        or ``"whole"``; ``wo``'s partial sums are reduced unless whole;
      * ``kv_heads``: the kv heads of a rank's decode pools (0: every
        head of the model);
      * ``fsdp``: the mesh axes of the logical ``embed`` axis under the
        plan's rules (FSDP, ``("data",)`` for the configs that override
        it; () for none): every weight's ``embed`` dim is cut over them
        where they divide it (``logical_spec``'s law), and gathered
        (``models.layers.gather_fsdp``) just before it is used;
      * ``seq``: sequence parallelism (the JAX plans' ``seq`` rule on
        "model", train and prefill): between blocks a rank holds its
        slice ``S/m`` of the sequence, slice r of the "model" axis, and
        the norms run on it; the input of every column-parallel product
        is gathered over the sequence first, and every row-parallel
        output's partial sums are reduce-scattered along it
        (``collectives.gather_dim``/``scatter_dim``); what every rank
        computes whole (a ``"whole"`` layer, GSPMD's expert cut, the
        experts' all-to-all) keeps the rank's slice
        (``collectives.split_dim``);
      * ``ring``: ring attention on the slices (the JAX ring plan,
        ``attn_seq`` on "model" too): every head's q/k/v of a rank's
        slice attend while the K/V slices rotate over "model"
        (``distributed.ring``) — under a train plan the heads' weights
        stay cut and a head↔seq all-to-all brings every head of the
        slice (GSPMD's around JAX's ring); under the ring prefill's
        layout the weights are whole (every layer ``"whole"``) and q/k/v
        come from the slice at its absolute positions;
      * ``act_embed``: weight-stationary decode (the JAX decode plan's
        ``ws_decode``: rules ``batch=None, act_embed=("data",)``): the
        mesh axes of ``act_embed`` under the plan's rules, when they hold
        more than one rank and divide ``d_model`` (``logical_spec``'s
        law); () otherwise, and in every train and prefill plan.  The
        decode step's activations are then the rank's columns (B,
        d/n) of the residual stream, slice ``flat_index(act_embed)``;
        every weight is read as the rank's slice of its ``embed`` dim —
        FSDP's piece where ``fsdp`` cuts it over the same axes, else a
        view of the whole weight (``models.layers.ws_pieces``) — and
        never gathered; a product that contracts ``embed`` sums its f32
        partials over these axes (``models.layers.ws_contract``), one
        that produces ``embed`` computes the rank's columns only;
      * ``state``: the RG-LRU blocks' ``w = lru_width`` channels over
        "model" (the JAX ``state`` rule, where "model" divides ``w``:
        ``logical_spec``'s law), in every train, prefill and decode plan:
        ``wx``/``wy`` by columns, ``conv``/``conv_b``/``a_log`` by
        channel, ``wa``/``wi`` and ``wout`` by rows, the recurrent state
        ``h`` and the conv window by channel.  The conv, the gates'
        elementwise part and the scan run on the rank's channels alone;
        ``wa``/``wi``'s f32 partials over the whole ``w`` are
        reduce-scattered so that each rank keeps its own columns of the
        gates, and ``wout``'s partial sums are reduced like ``wd``'s
        (``models.rglru``).  Otherwise every rank holds the block
        whole."""

    vocab: bool = False
    mlp: bool = False
    experts: bool = False
    ep: bool = False
    attn: Tuple[str, ...] = ()
    kv_heads: int = 0
    fsdp: Tuple[str, ...] = ()
    seq: bool = False
    ring: bool = False
    act_embed: Tuple[str, ...] = ()
    state: bool = False

    def moe(self) -> str:
        """What a rank does with the MoE experts: ``"whole"`` (it holds
        every expert), ``"cut"`` (GSPMD's: E/m experts over its own
        tokens, partial sums reduced over "model") or ``"ep"`` (E/m
        experts, the tokens exchanged by all-to-all)."""
        return "ep" if self.ep else "cut" if self.experts else "whole"

    def cut(self, layer: int) -> str:
        """Layer ``layer``'s entry of ``attn`` ("whole" with none)."""
        return self.attn[layer] if self.attn else "whole"

    def row_parallel(self, layer: int) -> bool:
        """Whether layer ``layer``'s ``wo`` holds only this rank's heads."""
        return self.cut(layer) != "whole"

    def rules(self) -> AxisRules:
        """The rule table that cuts the non-attention weights as this
        layout says (every other logical axis whole)."""
        on = {True: ("model",), False: None}
        return AxisRules({"vocab": on[self.vocab], "mlp": on[self.mlp],
                          "experts": on[self.experts],
                          "state": on[self.state],
                          "embed": self.fsdp or None})

    def attn_rules(self, layer: int) -> AxisRules:
        """The rule table of layer ``layer``'s attention weights: the
        q heads over "model" unless whole, the kv heads too under
        ``"heads"`` (under ``"groups"`` the head dim is cut, strided:
        the spec says which dim, not which heads), ``embed`` over the
        FSDP axes."""
        cut = self.cut(layer)
        return self.rules().extend(
            heads=("model",) if cut != "whole" else None,
            kv_heads=("model",) if cut == "heads" else None)


def fsdp_dims(spec_tree, layout: TPLayout, mesh):
    """Per ``ParamSpec`` leaf of ``spec_tree`` (a tree of dicts and
    lists): the dim ``layout.fsdp`` cuts on ``mesh`` (``logical_spec`` of
    its global shape), or None."""
    from repro_torch.models.spec import ParamSpec
    if isinstance(spec_tree, ParamSpec):
        if not layout.fsdp:
            return None
        spec = logical_spec(spec_tree.axes, AxisRules(
            {"embed": layout.fsdp}), mesh, spec_tree.shape)
        return next((d for d, e in enumerate(spec) if e is not None), None)
    if isinstance(spec_tree, dict):
        return {k: fsdp_dims(v, layout, mesh) for k, v in spec_tree.items()}
    return [fsdp_dims(v, layout, mesh) for v in spec_tree]


def logical_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[AxisRules] = None,
    mesh=None,
    shape: Optional[Sequence[int]] = None,
) -> PartitionSpec:
    """Resolve logical axes to a PartitionSpec.

    If ``shape`` is given, any mapping whose mesh-axis product does not
    divide the dimension is dropped (replicated): small smoke configs stay
    valid under the production rules.
    """
    rules = rules or current_rules()
    mesh = mesh or current_mesh()
    sizes = _mesh_axis_sizes(mesh) if mesh is not None else {}
    out = []
    used: set = set()
    for i, ax in enumerate(logical_axes):
        phys = rules.physical(ax)
        if phys is not None and mesh is not None:
            # drop mesh axes this mesh lacks ("pod" on one pod), so one
            # rule table serves every mesh
            phys = tuple(p for p in phys if p in sizes) or None
        if phys is not None and used.intersection(phys):
            # a mesh axis shards at most one dim; the first wins
            phys = None
        if phys is not None and shape is not None and mesh is not None:
            if shape[i] % math.prod(sizes.get(p, 1) for p in phys) != 0:
                phys = None
        if phys is None:
            out.append(None)
        elif len(phys) == 1:
            used.update(phys)
            out.append(phys[0])
        else:
            used.update(phys)
            out.append(tuple(phys))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def logical_shard(x: torch.Tensor, *logical_axes: Optional[str]
                  ) -> torch.Tensor:
    """The identity.  Under ``jit`` the JAX function constrains a global
    array's layout for GSPMD; here every rank runs eagerly on the tensors
    it holds, which are already its shards, so there is nothing to
    constrain."""
    return x


def shard_tensor(x: torch.Tensor, spec: Sequence, mesh) -> torch.Tensor:
    """This rank's piece of a full tensor ``x`` under ``spec`` (a resolved
    PartitionSpec): each sharded dim is cut into the product of its mesh
    axes' sizes, and the piece at the rank's flat (row-major) index over
    those axes is kept, contiguous, in a storage of its own (a narrowed
    view would keep the whole tensor's storage alive).  Unsharded tensors
    come back as they are."""
    out = x
    for dim, entry in enumerate(spec):
        axes = _norm(entry)
        if not axes:
            continue
        n = math.prod(mesh.size(a) for a in axes)
        if n == 1:
            continue
        idx = mesh.flat_index(axes)
        w = x.shape[dim] // n
        out = out.narrow(dim, idx * w, w)
    return out.clone(memory_format=torch.contiguous_format) if (
        out is not x) else x


def resolve_specs(spec_tree, rules: AxisRules, mesh):
    """The PartitionSpec of every ``ParamSpec`` leaf of ``spec_tree`` under
    ``rules`` on ``mesh`` (the tree ``shard_params`` cuts by; the JAX
    ``make_param_shardings`` without the devices)."""
    from repro_torch.models.spec import ParamSpec
    if isinstance(spec_tree, ParamSpec):
        return logical_spec(spec_tree.axes, rules, mesh, spec_tree.shape)
    if isinstance(spec_tree, dict):
        return {k: resolve_specs(v, rules, mesh)
                for k, v in spec_tree.items()}
    return [resolve_specs(s, rules, mesh) for s in spec_tree]


def shard_params(params, spec_tree, mesh, rules: AxisRules):
    """Cut a full parameter tree (dicts and lists of tensors, the shape of
    ``spec_tree``, a tree of ``ParamSpec``) to this rank's local pieces
    by each leaf's logical axes under ``rules`` (the port's counterpart
    of ``make_param_shardings``: the JAX package hands the specs to
    ``jit``; the port holds only its pieces)."""
    from repro_torch.models.spec import ParamSpec
    if isinstance(spec_tree, ParamSpec):
        return shard_tensor(params, logical_spec(
            spec_tree.axes, rules, mesh, tuple(params.shape)), mesh)
    if isinstance(spec_tree, dict):
        return {k: shard_params(params[k], spec_tree[k], mesh, rules)
                for k in params}
    return [shard_params(p, s, mesh, rules)
            for p, s in zip(params, spec_tree)]
