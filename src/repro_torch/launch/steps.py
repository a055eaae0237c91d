"""Sharding plans and the serve step (port of the serve half of
``repro.launch.steps``).

``plan_for`` picks, for a decode ``RunConfig`` and a mesh, the batch
axes, the rule table and the decode scheme, as the JAX function does:

  * batch axes: as much of ("pod", "data") as the global batch divides;
  * decode: ``tp`` when the model axis divides the kv heads, else ``dp``
    for windowed models, else ``kvp`` (a config's ``decode_scheme`` or
    ``scheme=`` asks for one); ``tp`` without that divisibility becomes
    ``kvp``, and ``kvp`` on a windowed model ``dp``; ``kvp`` stripes the
    pages over every axis not used for batch (``kv_axes``).

It also fixes the plan's ``layout`` (``distributed.sharding.TPLayout``):
which weights each rank holds a piece of, which the model cuts and reads.

``build_serve_step`` returns the decode step of one token per sequence
under the plan, on this rank's params (``model.init_params(..., plan=)``
or ``shard_params``) and state (``distributed.collectives.
shard_decode_state`` of a state prefilled under the plan).  The train and
prefill plans and step builders, the microbatched step, ``dryrun`` and
``hlo_analysis`` are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.distributed.sharding import (P, AxisRules, DEFAULT_RULES,
                                              TPLayout, logical_spec,
                                              use_mesh)
from repro_torch.errors import UnsupportedFeature


@dataclass
class Plan:
    run: RunConfig
    mesh: Any  # launch.mesh.Mesh
    rules: AxisRules
    batch_axes: Tuple[str, ...]
    scheme: str  # decode distribution scheme: tp | dp | kvp
    kv_axes: Tuple[str, ...]
    layout: TPLayout

    @property
    def n_kv_shards(self) -> int:
        return _mesh_prod(self.mesh, self.kv_axes) if (
            self.scheme == "kvp") else 1

    @property
    def attn_ctx(self) -> Dict[str, Any]:
        """What the model's ``prefill``/``decode_step`` read of the plan."""
        return {"scheme": self.scheme, "batch_axes": self.batch_axes,
                "layout": self.layout}


def _mesh_prod(mesh, axes: Tuple[str, ...]) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    return math.prod(sizes[a] for a in axes) if axes else 1


def plan_for(run: RunConfig, mesh, *, scheme: Optional[str] = None
             ) -> Plan:
    """The decode plan of ``run`` on ``mesh`` (the decode branch of the
    JAX ``plan_for``, line for line, plus the port's ``layout``)."""
    if run.kind != "decode":
        raise UnsupportedFeature(
            f"plan_for plans the decode step; the {run.kind!r} plans are "
            "not ported", kind=run.kind)
    cfg = run.model
    rules = DEFAULT_RULES.extend(**cfg.axis_overrides)
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    model_size = sizes.get("model", 1)

    # batch axes: use only as much of (pod, data) as the batch divides
    batch_axes: Tuple[str, ...] = ()
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and run.global_batch % (prod * sizes[a]) == 0:
            batch_axes += (a,)
            prod *= sizes[a]
    rules = rules.extend(batch=batch_axes or None)

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
    kv_axes = (tuple(a for a in mesh.axis_names if a not in batch_axes)
               if sch == "kvp" else ())
    return Plan(run=run, mesh=mesh, rules=rules, batch_axes=batch_axes,
                scheme=sch, kv_axes=kv_axes,
                layout=_layout(cfg, mesh, rules, sch, model_size))


def _layout(cfg: ModelConfig, mesh, rules: AxisRules, scheme: str,
            m: int) -> TPLayout:
    """Which weights a rank of the "model" axis holds a piece of: the
    vocab, ``d_ff`` and the experts (under ``moe_ep``) where the rules put
    them on "model" alone and it divides them; per layer, the heads under
    tp, and under dp (a windowed layer of a kvp plan too) the q heads of
    every group when ``m`` divides the group."""
    from repro_torch.distributed.collectives import layer_scheme
    if m == 1:
        return TPLayout(attn=("whole",) * cfg.n_layers,
                        kv_heads=cfg.n_kv_heads)

    def on_model(axis: str, dim: int) -> bool:
        return logical_spec((axis,), rules, mesh, (dim,)) == P("model")

    G = cfg.n_heads // cfg.n_kv_heads
    attn = []
    for code in cfg.pattern():
        s = layer_scheme(scheme, cfg.window if code == "W" else 0)
        attn.append("heads" if s == "tp" and code in "AW"
                    else "groups" if s == "dp" and code in "AW"
                    and G % m == 0 else "whole")
    return TPLayout(
        vocab=on_model("vocab", cfg.vocab_size),
        mlp=bool(cfg.d_ff) and on_model("mlp", cfg.d_ff),
        experts=cfg.moe_ep and cfg.is_moe and on_model(
            "experts", cfg.n_experts),
        attn=tuple(attn),
        kv_heads=cfg.n_kv_heads // m if scheme == "tp" else cfg.n_kv_heads)


def build_serve_step(run: RunConfig, plan: Plan, impl: str = "kernel"
                     ) -> Tuple[Callable, Any]:
    """Decode: one new token per sequence against the rank's KV cache
    under ``plan`` (the JAX ``build_serve_step``; the JAX one runs the
    oracle under ``jit``, the port K1/K2 unless ``impl="ref"``).  Returns
    ``(step, model)``: ``step(params, tokens, state) -> (logits (B_l, V),
    state)`` on this rank's params, tokens (its batch rows) and state,
    run under the plan's mesh and rules."""
    from repro_torch.models.api import build_model
    model = build_model(run.model)
    ctx = plan.attn_ctx

    def step(params, tokens, state):
        with use_mesh(plan.mesh, plan.rules):
            return model.decode_step(params, tokens, state, impl=impl,
                                     attn_ctx=ctx)

    return step, model
