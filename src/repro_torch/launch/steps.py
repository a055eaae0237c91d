"""Sharding plans and step builders for every (run × mesh) combination
(port of ``repro.launch.steps``).

``plan_for`` picks, for a ``RunConfig`` and a mesh, the batch axes, the
rule table, the decode scheme and the microbatches, as the JAX function
does, line for line:

  * batch axes: as much of ("pod", "data") as the global batch divides;
  * ``ring`` (train and prefill, "model" dividing the sequence): ``seq``
    and ``attn_seq`` over "model", under prefill the heads whole
    (``heads``/``kv_heads`` None), attention ``"ring"``;
  * train: under ``seq_parallel`` (the default, as JAX's) ``seq`` over
    "model" when it divides the sequence, and the microbatch count that
    keeps each rank's f32 logits under 256 MB;
  * prefill: the same ``seq`` rule, scheme ``"prefill_local"``;
  * decode: ``tp`` when the model axis divides the kv heads, else ``dp``
    for windowed models, else ``kvp`` (a config's ``decode_scheme`` or
    ``scheme=`` asks for one); ``tp`` without that divisibility becomes
    ``kvp``, and ``kvp`` on a windowed model ``dp``; ``kvp`` stripes the
    pages over every axis not used for batch (``kv_axes``);
  * ``ws_decode`` (weight-stationary decode, decode plans only): no batch
    axes (every rank holds every row, so kvp stripes over every mesh
    axis) and ``act_embed`` over "data": the activations are cut along
    ``embed`` instead of the rows, the FSDP weights stay where they are
    and the products' small f32 partials are all-reduced over "data"
    (``TPLayout.act_embed``).

It also fixes the plan's ``layout`` (``distributed.sharding.TPLayout``):
which weights each rank holds a piece of, which the model cuts and reads.
The train plan's is the tensor-parallel cut (heads over "model" when it
divides the kv heads, else q-head groups when it divides the group, else
GSPMD's contiguous q heads; ``d_ff`` and the vocab where the rules put
them on "model"), every MoE plan's experts over "model" where it divides
them, every plan's RG-LRU channels over "model" where it divides
``lru_width`` (the JAX ``state`` rule, ``TPLayout.state``: the blocks'
weights and their recurrent state), and every plan's ``embed`` dims over
the FSDP axes of its rules (the configs' ``embed: ("data",)``
override).  The prefill plan's is the
one the decode plan of the same config on the same mesh has, so that
the state a rank prefills is the state ``shard_decode_state``
takes: the JAX prefill plan shards the pools' head_dim over "model"
instead (a reshard at the phase boundary that the port does not make);
under the ring prefill its attention weights are whole (JAX's
``heads: None``), and its pools still the decode layout's.  Where the
rules put ``seq`` on a "model" axis of more than one rank, the layout's
``seq`` cuts the activations along the sequence between blocks, and
the ring plan's ``ring`` runs ring attention on those slices.

Every builder returns JAX's 4-tuple ``(step, args, specs, model)``:
``args`` are stand-ins of the global inputs on the ``meta`` device and
``specs`` the ``PartitionSpec`` trees of what each rank holds of them.
A step takes what its rank holds: its params (``model.init_params(...,
plan=)`` or ``shard_params``), its rows of the batch (``shard_batch``)
and its state.

  * ``build_train_step`` — loss, gradients, global-norm clipping and
    AdamW in place (the state is donated, as the JAX step's is), plain or
    over ``plan.microbatches`` with f32 accumulation of each rank's
    pieces; data-parallel over the batch axes (the loss is each rank's
    part of the global mean, the gradients summed: an FSDP piece's by the
    reduce-scatter of its gather), tensor-parallel over "model"
    (Megatron's f and g through ``distributed.collectives``), the
    activations cut along the sequence over "model" between blocks
    under ``layout.seq`` (Megatron-SP: gathered before each
    column-parallel product, reduce-scattered after each row-parallel
    one), whole otherwise;
  * ``build_prefill_step`` — each rank prefills its rows with its heads
    into ``model.init_decode_state(local_run(run, plan), plan=plan)``;
  * ``build_serve_step`` — one decode token per sequence.

The spec trees depart from the JAX ones where the port holds something
else than GSPMD would: the kv projections are cut with the q heads under
the ``"heads"`` cut, the ``"groups"`` cut takes G/m heads of every group
(strided) where GSPMD takes H/m contiguous ones, and the prefill pools
follow the decode layout (above), and the recurrent state ``rec`` is
cut by channel over "model" too where JAX's ``decode_state_shardings``
keeps it whole over "model" (its rows over the batch axes alike), so
that a decode step steps each rank's channels with no gather.
``embed`` over the FSDP axes,
``wq``/``wo`` by contiguous heads (``"q_heads"``) and the experts over
"model" in every MoE plan (GSPMD's cut, or the all-to-all of ``moe_ep``,
which picks only how a rank computes them) are GSPMD's.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.attention import TRAIN_IMPLS
from repro_torch.distributed.sharding import (P, AxisRules, DEFAULT_RULES,
                                              TPLayout, batch_axes_for,
                                              logical_spec, resolve_specs,
                                              shard_tensor, use_mesh)
from repro_torch.errors import UnsupportedFeature
from repro_torch.kernels import check_impl
from repro_torch.models import spec as pspec
from repro_torch.models.api import build_model
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.state import TrainState
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

# the per-rank f32 logits the microbatch search stays under (bytes)
LOGITS_BUDGET = 256e6


@dataclass
class Plan:
    """The JAX ``Plan`` of ``run`` on ``mesh`` (``plan_for``) and the
    port's ``layout``: the rank's cut of the weights, and under a train
    or prefill plan whose rules put ``seq`` on "model" (JAX's
    ``seq_parallel``, the default) the activations' cut along the
    sequence (``layout.seq``), with ring attention on it under the ring
    plan (``layout.ring``, ``attn_impl="ring"``); under a
    weight-stationary decode plan (``ws_decode``) the activations' cut
    along ``embed`` (``layout.act_embed``)."""
    run: RunConfig
    mesh: Any  # launch.mesh.Mesh
    rules: AxisRules
    batch_axes: Tuple[str, ...]
    scheme: str  # tp | dp | kvp (decode), prefill_local, n/a (train)
    kv_axes: Tuple[str, ...]
    microbatches: int
    attn_impl: str  # the train step's attention: ref | chunked | ring
    layout: TPLayout  # the rank's cut of the weights and the activations
    zero_pod: bool = False  # ZeRO-1: AdamW's moments cut over "pod" too

    @property
    def n_kv_shards(self) -> int:
        return _mesh_prod(self.mesh, self.kv_axes) if (
            self.scheme == "kvp") else 1

    @property
    def attn_ctx(self) -> Dict[str, Any]:
        """What the model's entry points read of the plan."""
        return {"scheme": self.scheme, "batch_axes": self.batch_axes,
                "layout": self.layout}


def _mesh_prod(mesh, axes: Tuple[str, ...]) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return math.prod(sizes[a] for a in axes) if axes else 1


def plan_for(run: RunConfig, mesh, *, microbatches: Optional[int] = None,
             attn_impl: str = "chunked", scheme: Optional[str] = None,
             seq_parallel: bool = True, ws_decode: bool = False,
             ring: bool = False, zero_pod: bool = False) -> Plan:
    """The plan of ``run`` on ``mesh`` (the JAX ``plan_for``, line for
    line, plus the port's ``layout``).  ``attn_impl`` names the port's
    training attention ("ref" is the JAX "jnp"); ``scheme`` asks for a
    decode scheme, and under a prefill plan for the layout of that
    decode scheme; ``seq_parallel`` cuts the train and prefill
    activations along the sequence over "model" between blocks, and
    ``ring`` runs ring attention on those slices (JAX's knobs and
    defaults); ``ws_decode`` makes a decode plan weight-stationary (no
    batch axes, ``act_embed`` over "data", ``TPLayout.act_embed``; train
    and prefill plans ignore it, as JAX's do); ``zero_pod`` cuts the
    train state's AdamW moments over "pod" too
    (``train_state_shardings``; the plan keeps it under train and
    decode, not prefill, as the JAX one does)."""
    cfg = run.model
    rules = DEFAULT_RULES.extend(**cfg.axis_overrides)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model_size = sizes.get("model", 1)

    # batch axes: use only as much of (pod, data) as the batch divides
    batch_axes = batch_axes_for(run.global_batch, mesh)
    prod = _mesh_prod(mesh, batch_axes)
    if ws_decode and run.kind == "decode":
        # weight-stationary decode: the FSDP weights stay in place and
        # the activations' small partials are summed over "data" instead
        batch_axes = ()
        rules = rules.extend(batch=None, act_embed=("data",))
    else:
        rules = rules.extend(batch=batch_axes or None)

    ringed = (ring and run.kind in ("train", "prefill")
              and run.seq_len % model_size == 0)
    if ringed:
        # ring attention: the activations stay cut along the sequence
        # through attention; for prefill q/k/v keep every head (the
        # weights whole), for training the heads stay cut (whole qkv
        # weights would un-shard their gradients)
        rules = rules.extend(seq=("model",), attn_seq=("model",))
        if run.kind == "prefill":
            rules = rules.extend(heads=None, kv_heads=None)
        attn_impl = "ring"
    if (run.kind in ("train", "prefill") and seq_parallel
            and run.seq_len % model_size == 0):
        # sequence parallelism: activations cut over "model" between blocks
        rules = rules.extend(seq=("model",))
    cut = {"seq": rules.physical("seq") == ("model",) and model_size > 1,
           "ring": ringed and model_size > 1}
    if run.kind == "train":
        if microbatches is None:
            # keep per-device f32 logits under ~256 MB
            vocab_shards = (model_size if cfg.vocab_size % model_size == 0
                            else 1)
            per_dev = (run.global_batch * run.seq_len // max(prod, 1)
                       * cfg.vocab_size // vocab_shards * 4)
            microbatches = 1
            while per_dev / microbatches > LOGITS_BUDGET and \
                    run.global_batch % (microbatches * 2 * prod) == 0:
                microbatches *= 2
        tp = "tp" if cfg.n_kv_heads % model_size == 0 else "dp"
        lay = _layout(cfg, mesh, rules, tp, model_size)
        return Plan(run=run, mesh=mesh, rules=rules, batch_axes=batch_axes,
                    scheme="n/a", kv_axes=(), microbatches=microbatches,
                    attn_impl=attn_impl,
                    layout=dataclasses.replace(lay, **cut),
                    zero_pod=zero_pod)
    sch = _decode_scheme(cfg, model_size, scheme)
    lay = _layout(cfg, mesh, rules, sch, model_size)
    if run.kind == "prefill":
        if cut["ring"]:  # the weights whole, the pools the decode layout's
            lay = dataclasses.replace(lay, attn=("whole",) * len(lay.attn))
        return Plan(run=run, mesh=mesh, rules=rules, batch_axes=batch_axes,
                    scheme="prefill_local", kv_axes=(), microbatches=1,
                    attn_impl=attn_impl,
                    layout=dataclasses.replace(lay, **cut))
    kv_axes = (tuple(a for a in mesh.axis_names if a not in batch_axes)
               if sch == "kvp" else ())
    act = tuple(a for a in mesh.axis_names
                if a in (rules.physical("act_embed") or ()))
    if _mesh_prod(mesh, act) <= 1 or cfg.d_model % _mesh_prod(mesh, act):
        act = ()  # the activations stay whole
    return Plan(run=run, mesh=mesh, rules=rules, batch_axes=batch_axes,
                scheme=sch, kv_axes=kv_axes, microbatches=1,
                attn_impl=attn_impl,
                layout=dataclasses.replace(lay, act_embed=act),
                zero_pod=zero_pod)


def _decode_scheme(cfg: ModelConfig, model_size: int,
                   scheme: Optional[str]) -> str:
    window = cfg.window if "W" in cfg.pattern() else 0
    sch = scheme or cfg.decode_scheme
    if sch in ("auto", "n/a"):
        if cfg.n_kv_heads % model_size == 0:
            sch = "tp"
        elif window > 0:
            sch = "dp"
        else:
            sch = "kvp"
    if sch == "tp" and cfg.n_kv_heads % model_size != 0:
        sch = "kvp"
    if sch == "kvp" and window > 0:
        sch = "dp"
    return sch


def _layout(cfg: ModelConfig, mesh, rules: AxisRules, scheme: str,
            m: int) -> TPLayout:
    """Which weights a rank holds a piece of: over "model", the vocab,
    ``d_ff``, the experts and the RG-LRU channels (``state``: the blocks'
    ``lru_width``) where the rules put them on "model" alone and it
    divides them (the experts under GSPMD's cut, or exchanged by
    all-to-all under the config's ``moe_ep``: ``TPLayout.moe``), in
    train, prefill and decode plans alike; per ``A``/``W`` layer, the heads
    under tp, under dp (a windowed layer of a kvp plan too) the q heads
    of every group when ``m`` divides the group, else (kvp, and dp where
    ``m`` divides no group) ``m``'s contiguous share of the q heads when
    it divides them; over the FSDP axes (the mesh axes of ``embed`` under
    the rules, when they hold more than one rank) every ``embed`` dim."""
    from repro_torch.distributed.collectives import layer_scheme
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    fsdp = tuple(a for a in rules.physical("embed") or () if a in sizes)
    fsdp = fsdp if math.prod(sizes[a] for a in fsdp) > 1 else ()
    if m == 1:
        return TPLayout(attn=("whole",) * cfg.n_layers,
                        kv_heads=cfg.n_kv_heads, fsdp=fsdp)

    def on_model(axis: str, dim: int) -> bool:
        return logical_spec((axis,), rules, mesh, (dim,)) == P("model")

    G = cfg.n_heads // cfg.n_kv_heads
    attn = []
    for code in cfg.pattern():
        s = layer_scheme(scheme, cfg.window if code == "W" else 0)
        attn.append("whole" if code not in "AW"
                    else "heads" if s == "tp"
                    else "groups" if s == "dp" and G % m == 0
                    else "q_heads" if cfg.n_heads % m == 0 else "whole")
    experts = cfg.is_moe and on_model("experts", cfg.n_experts)
    return TPLayout(
        vocab=on_model("vocab", cfg.vocab_size),
        mlp=bool(cfg.d_ff) and on_model("mlp", cfg.d_ff),
        experts=experts, ep=experts and cfg.moe_ep,
        attn=tuple(attn),
        kv_heads=cfg.n_kv_heads // m if scheme == "tp" else cfg.n_kv_heads,
        fsdp=fsdp,
        state="R" in cfg.pattern() and on_model(
            "state", cfg.lru_width or cfg.d_model))


# ---------------------------------------------------------------------------
# spec trees: what each rank holds
# ---------------------------------------------------------------------------
def _entry(axes: Tuple[str, ...]):
    """A PartitionSpec entry of ``axes`` (None, one name or a tuple)."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def _spec(*entries) -> P:
    out = list(entries)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _cuts(spec: P, axis: str) -> bool:
    """Whether ``spec`` cuts a dim over mesh axis ``axis``."""
    return any(e == axis or (isinstance(e, tuple) and axis in e)
               for e in spec)


def spec_leaves(tree) -> list:
    """The ``PartitionSpec`` leaves of a spec tree, in ``tree_leaves``
    order (a spec is a tuple, which the tree utilities would enter)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in spec_leaves(getattr(tree, f))]
    return [x for t in tree for x in spec_leaves(t)]


def param_specs(model, plan: Plan, fsdp: Optional[Tuple[str, ...]] = None):
    """The spec tree of the pieces ``model.shard_params(params, plan)``
    keeps, by ``plan.layout``: the vocab, ``d_ff`` and the experts over
    "model" as the layout says; attention by layer
    (``TPLayout.attn_rules``) — ``"heads"``: ``wq``/``wk``/``wv`` by heads
    and ``wo`` by its head rows, ``"groups"`` and ``"q_heads"``:
    ``wq``/``wo`` by heads (under ``"groups"`` G/m of every kv group: the
    spec says that the head dim is cut, not which heads), ``"whole"``;
    every ``embed`` dim over the layout's FSDP axes, or over ``fsdp``
    when given (the moments of ``train_state_shardings``)."""
    lay = plan.layout if fsdp is None else dataclasses.replace(
        plan.layout, fsdp=fsdp)
    spec = model.param_spec()
    out = {k: resolve_specs(v, lay.rules(), plan.mesh)
           for k, v in spec.items() if k != "layers"}
    if "layers" not in spec:
        return out
    out["layers"] = []
    for li, ls in enumerate(spec["layers"]):
        d = {k: resolve_specs(v, lay.rules(), plan.mesh)
             for k, v in ls.items() if k != "attn"}
        if "attn" in ls:
            d["attn"] = resolve_specs(ls["attn"], lay.attn_rules(li),
                                      plan.mesh)
        out["layers"].append(d)
    return out


def train_state_shardings(model, plan: Plan) -> TrainState:
    """Specs of the train state each rank holds: its params' pieces
    (``param_specs``), the AdamW moments alike, the counters whole.
    Under ``plan.zero_pod`` on a mesh with "pod" (ZeRO-1 over pods, the
    JAX rule) each moment's ``embed`` dim is cut over ("pod", *the FSDP
    axes*) in that order, where they divide it together (else it stays
    the params' cut); the params stay whole over "pod"."""
    p = param_specs(model, plan)
    mom = p
    fsdp = plan.layout.fsdp
    if plan.zero_pod and "pod" in plan.mesh.axis_names and "pod" not in fsdp:
        mom = param_specs(model, plan, ("pod",) + fsdp)
    return TrainState(params=p, opt=AdamWState(mu=mom, nu=mom, count=P()),
                      step=P())


def _axes_at(spec: P, dim: int) -> Tuple[str, ...]:
    """The mesh axes of entry ``dim`` of ``spec`` (() past its end)."""
    e = spec[dim] if dim < len(spec) else None
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _cut_axes(spec: P, mesh) -> Tuple[str, ...]:
    """The mesh axes that cut some dim of ``spec``, in the mesh's order."""
    return tuple(a for a in mesh.axis_names if _cuts(spec, a))


def batch_shardings(run: RunConfig, plan: Plan) -> Dict[str, P]:
    ba = _entry(plan.batch_axes)
    out = {"inputs": _spec(ba, None), "targets": _spec(ba, None)}
    cfg = run.model
    if cfg.family == "vlm":
        out["image_embeds"] = _spec(ba, None, None)
    if cfg.family == "encdec":
        out["frames"] = _spec(ba, None, None)
    return out


def decode_state_shardings(model, plan: Plan, state: Dict) -> Dict:
    """Specs of the decode/prefill state each rank holds, keyed like the
    state: rows over the batch axes; the pools' pages over the batch axes
    (and under kvp the kv axes too), their kv heads over "model" where
    the layout cuts them (tp, and a prefill under a tp layout); kvp's
    tables by stripe; the ``R`` layers' recurrent state by channel over
    "model" under ``layout.state`` (JAX keeps it whole over "model")."""
    ba = _entry(plan.batch_axes)
    pages = tuple(plan.batch_axes) + (
        tuple(plan.kv_axes) if plan.scheme == "kvp" else ())
    kv = _entry(plan.kv_axes)
    kvh = ("model" if plan.layout.kv_heads
           and plan.layout.kv_heads != model.cfg.n_kv_heads else None)
    out: Dict[str, Any] = {}
    for key, val in state.items():
        if key == "pos":
            out[key] = _spec(ba)
        elif key in ("k_pages", "v_pages"):
            out[key] = _spec(None, _entry(pages), None, kvh, None)
        elif key == "tables":
            out[key] = _spec(ba, kv if plan.scheme == "kvp" else None, None)
        elif key in ("cross_k", "cross_v", "k_buf", "v_buf"):
            out[key] = _spec(None, ba)
        elif key == "rec":
            ch = "model" if plan.layout.state else None
            out[key] = {code: {k: _spec(None, ba, *(None,) * (a.dim() - 3),
                                        ch if code == "R" else None)
                               for k, a in leaves.items()}
                        for code, leaves in val.items()}
        else:
            out[key] = P()
    return out


# ---------------------------------------------------------------------------
# stand-ins and the rank's share of the inputs
# ---------------------------------------------------------------------------
def abstract_batch(run: RunConfig, dtype=torch.bfloat16
                   ) -> Dict[str, torch.Tensor]:
    """Stand-ins of a train batch of ``run``'s shape on ``meta``."""
    from repro_torch.models.api import input_specs
    return input_specs(dataclasses.replace(run, kind="train"), dtype)


def abstract_train_state(model, dtype=torch.bfloat16,
                         moment_dtype=None) -> TrainState:
    p = pspec.abstract(model.param_spec(), dtype)
    mom = pspec.abstract(model.param_spec(), moment_dtype or dtype)
    scalar = torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(params=p, opt=AdamWState(mu=mom, nu=mom, count=scalar),
                      step=scalar)


def _abstract_state(model, run: RunConfig, plan: Plan, dtype) -> Dict:
    """The global decode state on ``meta``: every kv head, and under kvp
    the JAX layout (pages per sequence rounded up to the stripes, tables
    (B, n, pages / n))."""
    st = model.init_decode_state(run, dtype, device="meta")
    n = plan.n_kv_shards
    if n > 1:
        B, _, pps = st["tables"].shape
        pps = -(-pps // n) * n
        L, _, ps, H, D = st["k_pages"].shape
        for k in ("k_pages", "v_pages"):
            st[k] = torch.empty((L, B * pps, ps, H, D), dtype=st[k].dtype,
                                device="meta")
        st["tables"] = torch.empty((B, n, pps // n), dtype=torch.int32,
                                   device="meta")
    return st


def local_run(run: RunConfig, plan: Plan) -> RunConfig:
    """``run`` with this rank's rows: the global batch over the plan's
    batch axes."""
    nb = _mesh_prod(plan.mesh, plan.batch_axes)
    return dataclasses.replace(run, global_batch=run.global_batch // nb)


def shard_batch(batch: Dict[str, torch.Tensor], plan: Plan
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of each tensor of a global batch (its piece under
    ``P(batch_axes)``: the rows of its row-major index over the axes)."""
    rows = _spec(_entry(plan.batch_axes))
    return {k: shard_tensor(v, rows, plan.mesh) for k, v in batch.items()}


def _n_ranks(mesh) -> int:
    return math.prod(mesh.shape)


# ---------------------------------------------------------------------------
# step builders (return step, stand-ins of the global inputs, their specs,
# model)
# ---------------------------------------------------------------------------
def train_grads(model, plan: Plan) -> Callable:
    """``grads(params, batch) -> (loss, parts, grads)``: the train step of
    ``plan`` up to the clipping, on this rank's params and rows.  With
    ``plan.microbatches`` = mb > 1 the rows are cut into mb consecutive
    parts whose gradients are accumulated in f32 and divided by mb (the
    JAX body).  Over the batch axes each rank's loss is its part of the
    global mean (``layers.xent``; the MoE aux loss is the whole batch's,
    under ``moe_ep`` the mean of each shard's, JAX's EP law) and the
    gradients are summed over them — an FSDP piece's over the batch axes
    off the FSDP axes only, the reduce-scatter of its gather having
    summed it over those, and an expert's over the batch axes only; over
    "model" each rank computes its heads, ``d_ff`` columns, vocab slice
    and experts, and under ``layout.seq`` its slice of the sequence
    between blocks.  The accumulator and the
    gradients are the rank's pieces.  ``loss`` and ``parts`` (``ce``,
    ``aux``) are the global batch's."""
    from repro_torch.distributed.collectives import all_reduce, spans
    from repro_torch.training.loop import loss_and_grads
    ctx = plan.attn_ctx if _n_ranks(plan.mesh) > 1 else None
    mb, ba = plan.microbatches, tuple(plan.batch_axes)
    coef = plan.run.model.router_aux_coef
    fsdp = set(plan.layout.fsdp)
    # per leaf, the batch axes its gradient is still to be summed over
    sums = [tuple(a for a in ba if not (a in fsdp and _cuts(s, a)))
            for s in spec_leaves(param_specs(model, plan))]

    def grads_of(params, batch):
        with use_mesh(plan.mesh, plan.rules):
            if mb == 1:
                loss, parts, grads = loss_and_grads(
                    model, params, batch, plan.attn_impl, ctx)
            else:
                b = next(iter(batch.values())).shape[0] // mb
                acc, loss, parts = None, 0.0, {}
                for i in range(mb):
                    sub = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                    l_i, p_i, g_i = loss_and_grads(
                        model, params, sub, plan.attn_impl, ctx)
                    g_i = tree_leaves(g_i)
                    acc = ([g.float() for g in g_i] if acc is None
                           else [a + g.float() for a, g in zip(acc, g_i)])
                    loss = loss + l_i
                    parts = {k: parts.get(k, 0.0) + v
                             for k, v in p_i.items()}
                grads = tree_unflatten(params, [a / mb for a in acc])
                loss = loss / mb
                parts = {k: v / mb for k, v in parts.items()}
            if spans(ba):
                grads = tree_unflatten(grads, [
                    all_reduce(g, axes) for g, axes in zip(
                        tree_leaves(grads), sums)])
                parts["ce"] = all_reduce(parts["ce"], ba)
                loss = parts["ce"] + coef * parts["aux"]
        return loss, parts, grads

    return grads_of


def build_train_step(run: RunConfig, plan: Plan, dtype=torch.bfloat16,
                     lr=3e-4, moment_dtype=None):
    """``step(state, batch) -> (state', metrics)`` on this rank's train
    state and rows (``shard_batch``), at learning rate ``lr`` (the rate
    the JAX builder fixes, by default): ``train_grads``, then global-norm
    clipping at 1.0 (each leaf's squares summed over every mesh axis
    that cuts it) and AdamW in place (``adamw_update_``): ``state`` is
    donated, as the JAX step donates its state — ``state'`` holds the
    same storages, updated, and the caller's ``state`` is no longer the
    one before the step.  Under ``plan.zero_pod`` (ZeRO-1 over pods) each
    rank updates the slice of every leaf whose moments it holds cut
    (``train_state_shardings``: over ("pod", *the FSDP axes*), of which
    its params hold the slice over the FSDP axes) and an ``all_gather``
    over the moments' axes rebuilds its params' piece: the numbers of
    the plain step.  ``metrics``: ``loss``, ``grad_norm``, ``ce`` and
    ``aux``, the global batch's."""
    from repro_torch.training.optimizer import (adamw_update_,
                                                clip_by_global_norm)
    model = build_model(run.model)
    check_impl(plan.attn_impl, TRAIN_IMPLS, "build_train_step")
    specs = {"state": train_state_shardings(model, plan),
             "batch": batch_shardings(run, plan)}
    mesh = plan.mesh
    pspecs = spec_leaves(specs["state"].params)
    cut_axes = [_cut_axes(s, mesh) for s in pspecs]
    # per leaf whose moments are cut further than its params: the dim and
    # the params' and the moments' axes along it
    zero = [next(((d, _axes_at(ps, d), _axes_at(ms, d))
                  for d in range(max(len(ps), len(ms)))
                  if _axes_at(ps, d) != _axes_at(ms, d)), None)
            for ps, ms in zip(pspecs, spec_leaves(specs["state"].opt.mu))]
    grads_of = train_grads(model, plan)

    def update(grads, state: TrainState) -> AdamWState:
        if not any(zero):
            return adamw_update_(grads, state.opt, state.params, lr=lr)
        from repro_torch.distributed.collectives import all_gather_dim
        opt = state.opt
        with use_mesh(mesh, plan.rules):
            # leaf by leaf, so that one leaf's gathered copies are alive
            # at a time
            for g, p, m, v, z in zip(
                    tree_leaves(grads), tree_leaves(state.params),
                    tree_leaves(opt.mu), tree_leaves(opt.nu), zero):
                one = AdamWState(mu=[m], nu=[v], count=opt.count)
                if z is None:
                    adamw_update_([g], one, [p], lr=lr)
                    continue
                d, pa, ma = z
                # the param and gradient along d as whole as the moments'
                # cut needs, then the moments' slice of them
                g_w, p_w = all_gather_dim(g, pa, d), all_gather_dim(p, pa, d)
                w = p_w.shape[d] // mesh.prod(ma)
                lo = mesh.flat_index(ma) * w
                x = p_w.narrow(d, lo, w)
                adamw_update_([g_w.narrow(d, lo, w)], one, [x], lr=lr)
                del g_w
                n = p.shape[d]
                p.copy_(all_gather_dim(x, ma, d).narrow(
                    d, mesh.flat_index(pa) * n, n))
        return AdamWState(mu=opt.mu, nu=opt.nu, count=opt.count + 1)

    def step(state: TrainState, batch: Dict) -> Tuple[TrainState, Dict]:
        loss, parts, grads = grads_of(state.params, batch)
        with use_mesh(mesh, plan.rules):
            grads, gnorm = clip_by_global_norm(grads, 1.0, cut_axes)
        opt = update(grads, state)
        metrics = {"loss": loss, "grad_norm": gnorm, **parts}
        return TrainState(state.params, opt, state.step + 1), metrics

    args = {"state": abstract_train_state(model, dtype, moment_dtype),
            "batch": abstract_batch(run, dtype)}
    return step, args, specs, model


def _inference_model(run: RunConfig):
    """The model of ``run``'s prefill or serve step: a family with a paged
    decode state (every family but the encoder–decoder); its layer codes
    are checked where the state is built (``init_decode_state``)."""
    model = build_model(run.model)
    if not hasattr(model, "init_decode_state"):
        raise UnsupportedFeature(
            f"the prefill and serve steps take models of 'A', 'W' and 'R' "
            f"layers; family {run.model.family!r}", family=run.model.family)
    return model


def build_prefill_step(run: RunConfig, plan: Plan, dtype=torch.bfloat16,
                       impl: str = "kernel"):
    """``step(params, tokens, lens, state) -> (last-token logits, state)``
    on this rank's params, rows (``shard_batch`` of ``tokens``/``lens``)
    and state, ``model.init_decode_state(local_run(run, plan),
    plan=plan)`` with its tables mapped: the rank prefills its rows with
    its heads (K4 unless ``impl="ref"``) into pools of the kv heads its
    decode layout holds, which ``shard_decode_state`` then takes as they
    are; under ``layout.seq`` with its slice of the sequence between
    blocks, under ``layout.ring`` through ring attention (plain ops) with
    the attention weights whole, so that the decode plan's params are
    another cut of them; the ``R`` layers' state of the rank's rows and
    channels (``layout.state``) comes back in ``rec``.  Models of ``A``,
    ``W`` and ``R`` layers (a cross-attention or ``M``/``S`` state is not
    distributed: ``UnsupportedFeature``)."""
    model = _inference_model(run)
    B, S = run.global_batch, run.seq_len
    state = _abstract_state(model, run, plan, dtype)
    ba = _entry(plan.batch_axes)
    ctx = plan.attn_ctx

    def step(params, tokens, lens, state):
        with use_mesh(plan.mesh, plan.rules), torch.no_grad():
            return model.prefill(params, tokens, state, lens, impl=impl,
                                 attn_ctx=ctx)

    args = {"params": pspec.abstract(model.param_spec(), dtype),
            "tokens": torch.empty((B, S), dtype=torch.int32, device="meta"),
            "lens": torch.empty((B,), dtype=torch.int32, device="meta"),
            "state": state}
    specs = {"params": param_specs(model, plan), "tokens": _spec(ba, None),
             "lens": _spec(ba),
             "state": decode_state_shardings(model, plan, state)}
    return step, args, specs, model


def build_serve_step(run: RunConfig, plan: Plan, dtype=torch.bfloat16,
                     impl: str = "kernel"):
    """Decode: one new token per sequence against the rank's KV cache
    under ``plan`` (the JAX ``build_serve_step``; the JAX one runs the
    oracle under ``jit``, the port K1/K2 unless ``impl="ref"``).
    ``step(params, tokens, state) -> (logits (B_l, V), state)`` on this
    rank's params, tokens (its batch rows) and state
    (``shard_decode_state`` of a state prefilled under the plan's
    layout), run under the plan's mesh and rules."""
    model = _inference_model(run)
    state = _abstract_state(model, run, plan, dtype)
    ctx = plan.attn_ctx

    def step(params, tokens, state):
        with use_mesh(plan.mesh, plan.rules):
            return model.decode_step(params, tokens, state, impl=impl,
                                     attn_ctx=ctx)

    args = {"params": pspec.abstract(model.param_spec(), dtype),
            "tokens": torch.empty((run.global_batch,), dtype=torch.int32,
                                  device="meta"),
            "state": state}
    specs = {"params": param_specs(model, plan),
             "tokens": _spec(_entry(plan.batch_axes)),
             "state": decode_state_shardings(model, plan, state)}
    return step, args, specs, model


def build_step(run: RunConfig, plan: Plan, dtype=torch.bfloat16, **kw):
    """The builder of ``run.kind``; ``kw`` goes to it (``lr=`` to the train
    step, ``impl=`` to the prefill and serve steps)."""
    if run.kind == "train":
        return build_train_step(run, plan, dtype, **kw)
    if run.kind == "prefill":
        return build_prefill_step(run, plan, dtype, **kw)
    return build_serve_step(run, plan, dtype, **kw)


# ---------------------------------------------------------------------------
# the dry run's trace (the port's counterpart of the JAX ``lower_step``)
# ---------------------------------------------------------------------------
def rank_inputs(run: RunConfig, plan: Plan, dtype=torch.bfloat16, **kw):
    """``(step, inputs, model)``: ``build_step``'s step and this rank's
    share of its inputs by argument name, in the step's argument order,
    as ``meta`` stand-ins (each global stand-in cut by its spec:
    ``shard_tensor`` on the plan's mesh and the rank's coordinates)."""
    step, args, specs, model = build_step(run, plan, dtype, **kw)
    mine = {name: tree_map(lambda t, s: shard_tensor(t, s, plan.mesh),
                           args[name], specs[name]) for name in args}
    return step, mine, model


def dry_step(run: RunConfig, plan: Plan, dtype=torch.bfloat16, **kw):
    """Trace the step of ``run`` under ``plan`` once for the rank of
    ``plan.mesh`` (a dry mesh, ``launch.mesh.make_dry_mesh``, or the
    local 1 x 1 mesh), on fake "cpu" tensors of that rank's inputs
    (``rank_inputs``), under ``FakeTensorMode`` with a ``ShapeEnv``,
    ``kernels.dry_mode`` (each kernel of the card's path stands in by
    its output shapes, operations and bytes) and ``cost_analysis.
    record_step`` (FLOPs, bytes, the storages' peak, the mesh's
    collectives).  Returns the ``cost_analysis.StepRecord``; nothing is
    allocated, built or sent.  ``kw`` goes to ``build_step``.

    A data-dependent size counts at its upper bound (the fits-proof may
    only err high): the boolean-mask writes of ``core.cache.
    _scatter_tokens`` (``pages[phys[keep], off[keep]]``, on every prefill
    and decode write) keep every token of the mask's input, and the MoE's
    count of live tokens read on the host (``utils.fake.count_true`` in
    ``TransformerModel._live_tokens``, ``moe.apply_moe`` and
    ``ep.apply_moe_ep``) is every token.  ``models.attention.
    chunk_cross_mode`` (a host read) is on the chunk steps only, which no
    dry step runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    from repro_torch import kernels
    from repro_torch.launch.cost_analysis import record_step
    step, mine, _ = rank_inputs(run, plan, dtype, **kw)
    fake = FakeTensorMode(shape_env=ShapeEnv())
    tally = kernels.KernelTally()
    with fake, kernels.dry_mode(tally):
        args = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="cpu"),
                        list(mine.values()))
        return record_step(step, args, plan.mesh, tally)
