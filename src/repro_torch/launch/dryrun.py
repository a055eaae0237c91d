"""Multi-pod dry run: prove every (arch × shape × mesh) traces and fits,
without a GPU (port of ``repro.launch.dryrun``).

For one pair this script:
  1. builds the production mesh, (16, 16) single-pod or (2, 16, 16)
     multi-pod, as a dry mesh seen from one rank (``--rank``, 0 by
     default): no process group, no card;
  2. traces the rank's step (train / prefill / decode, ``steps.
     dry_step``) once on fake tensors of its share of the inputs: the
     card's path, each kernel (K4 on prefill, K1 and K2 on decode, K2
     "dist" under kvp) standing in by its output shapes, operations and
     bytes;
  3. records the rank's memory (the fits-proof: ``fits`` is the peak
     against the H100's 80 GB), FLOPs and HBM bytes, the collectives'
     bytes within a node and beyond it, and the roofline terms
     (``cost_analysis``).

The train and prefill plans cut the activations along the sequence over
"model" between blocks by default, as JAX's do (``--no-seqpar`` keeps
them whole); ``--ring`` runs ring attention on the slices (the ring's
sends to the next rank, and under grad back to the previous one, are
counted like the gathers and reduce-scatters: within a node or beyond
it as the "model" group spans); ``--ws-decode`` makes the decode plan
weight-stationary (JAX's ``ws_decode``: no batch axes, kvp over every
mesh axis, the activations cut along ``embed`` over "data" and the FSDP
weights never gathered).  Each output's ``plan`` records the knobs, and
under ``--ws-decode`` the ws plan's batch axes, kv axes, activation cut
and rules (``plan["ws"]``); ``collectives_by_axes`` splits the
collectives by the mesh axes each group spans (FSDP's weight gathers
are the all-gathers over "data", the kvp merge's those over its stripe
axes).

Every number is a prediction from the datasheet constants of
``launch.mesh``, not a measurement.  No kernel is built.

Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>[__tag]
.json.  A pair the JAX package skips is ``"skipped"``; one the port
refuses (``UnsupportedFeature``: a layer pattern the distributed steps do
not take — ``C``, ``M``, ``S`` — or a family without a paged decode
state, the encoder–decoder) is ``"unsupported"``
with the reason; only ``"error"`` makes the exit code nonzero.

Usage:
  python -m repro_torch.launch.dryrun --arch llama2-7b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --mesh pod
  python -m repro_torch.launch.dryrun --arch llama3-405b \
      --shape train_4k,prefill_32k --ring --tag ring
  python -m repro_torch.launch.dryrun --arch llama3-405b \
      --shape decode_32k,long_500k --ws-decode --tag ws
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import ASSIGNED, INPUT_SHAPES, get_config, make_run
from repro_torch.configs.base import RunConfig
from repro_torch.core.attention import TRAIN_IMPLS
from repro_torch.errors import UnsupportedFeature
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import HBM_BYTES, make_production_mesh
from repro_torch.launch.steps import dry_step, plan_for

SKIPS = {
    # (arch, shape): reason — recorded, not silently dropped
    ("whisper-medium", "long_500k"):
        "decoder is bounded by design (448 positions; enc-dec cross-attn "
        "is fixed-length) — a 524k-token decoder context is architecturally "
        "meaningless (DESIGN.md §5)",
}

# archs that need the sliding-window variant to make long_500k sub-quadratic
SWA_FOR_LONG = {"nemotron-4-340b", "nemotron-4-15b", "llama3-405b",
                "granite-8b", "granite-moe-1b-a400m", "olmoe-1b-7b",
                "llama-3.2-vision-11b", "llama2-7b"}


def make_run_for(arch: str, shape: str) -> Optional[RunConfig]:
    if (arch, shape) in SKIPS:
        return None
    variant = "swa" if (shape == "long_500k" and arch in SWA_FOR_LONG) else "base"
    cfg = get_config(arch)
    if shape == "train_4k" and cfg.remat == "none":
        cfg = cfg.replace(remat="full")
    return make_run(cfg, shape, variant=variant)


def run_pair(arch: str, shape: str, multi_pod: bool,
             microbatches: Optional[int] = None,
             scheme: Optional[str] = None,
             attn_impl: str = "chunked",
             tag: str = "",
             overrides: Optional[Dict[str, Any]] = None,
             zero_pod: bool = False,
             rank: int = 0,
             seq_parallel: bool = True,
             ring: bool = False,
             ws_decode: bool = False) -> Dict[str, Any]:
    run = make_run_for(arch, shape)
    if run is not None and overrides:
        run = dataclasses.replace(run, model=run.model.replace(**overrides))
    mesh_name = "multipod" if multi_pod else "pod"
    out: Dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "tag": tag, "rank": rank}
    if run is None:
        out["status"] = "skipped"
        out["reason"] = SKIPS[(arch, shape)]
        return out

    mesh = make_production_mesh(multi_pod=multi_pod, dry=True, rank=rank)
    n_dev = math.prod(mesh.shape)
    plan = plan_for(run, mesh, microbatches=microbatches, scheme=scheme,
                    attn_impl=attn_impl, zero_pod=zero_pod,
                    seq_parallel=seq_parallel, ring=ring,
                    ws_decode=ws_decode)
    out["plan"] = {"batch_axes": plan.batch_axes, "scheme": plan.scheme,
                   "kv_axes": plan.kv_axes, "microbatches": plan.microbatches,
                   "variant": run.variant, "zero_pod": plan.zero_pod,
                   "seq_parallel": seq_parallel, "ring": ring,
                   "ws_decode": ws_decode,
                   "seq": plan.layout.seq, "attn_impl": plan.attn_impl,
                   "attn": sorted(set(plan.layout.attn)),
                   "experts": plan.layout.moe(),
                   "state": plan.layout.state,
                   "rules": {k: v for k, v in plan.rules.table.items()
                             if v is not None}}
    if ws_decode and run.kind == "decode":
        out["plan"]["ws"] = {
            "batch_axes": plan.batch_axes, "kv_axes": plan.kv_axes,
            "n_kv_shards": plan.n_kv_shards,
            "act_embed": plan.layout.act_embed, "fsdp": plan.layout.fsdp,
            "rules": {k: plan.rules.table.get(k)
                      for k in ("batch", "act_embed", "embed")}}
    try:
        rec = dry_step(run, plan, torch.bfloat16)
    except UnsupportedFeature as e:
        out["status"] = "unsupported"
        out["reason"] = str(e)
        return out
    out["trace_s"] = round(rec.seconds, 1)
    out["memory"] = ca.memory_stats(rec)
    out["fits"] = out["memory"]["peak_bytes"] <= HBM_BYTES
    out["cost_full"] = ca.extract_cost(rec)
    out["collectives_full"] = ca.collective_bytes(rec.stats)
    out["collectives_by_axes"] = ca.collective_bytes_by_axes(rec.stats,
                                                             mesh)
    out["collective_calls"] = rec.stats["calls"]
    out["kernels"] = dict(sorted(rec.kernels.launches.items()))
    out["status"] = "ok"

    cost = out["cost_full"]
    terms = ca.roofline_terms(cost["flops"], cost["bytes"],
                              out["collectives_full"])
    n_tokens = (run.global_batch * run.seq_len if run.kind != "decode"
                else run.global_batch)
    mf_total = ca.model_flops(run.model, n_tokens, run.kind)
    terms["model_flops_per_dev"] = mf_total / n_dev
    terms["useful_frac"] = (mf_total / n_dev) / max(cost["flops"], 1.0)
    out["roofline"] = terms
    return out


def parse_overrides(text: str) -> Dict[str, Any]:
    """"key=val,..." ModelConfig overrides (True/False and integers
    parsed)."""
    overrides: Dict[str, Any] = {}
    for kv in (text.split(",") if text else []):
        k, v = kv.split("=")
        overrides[k] = {"True": True, "False": False}.get(
            v, int(v) if v.isdigit() else v)
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--scheme", default=None)
    ap.add_argument("--attn-impl", default="chunked", choices=TRAIN_IMPLS)
    ap.add_argument("--override", default="",
                    help="comma key=val ModelConfig overrides, "
                         "e.g. --override n_layers=4,remat=none")
    ap.add_argument("--tag", default="")
    ap.add_argument("--zero-pod", action="store_true",
                    help="ZeRO-1: cut AdamW's moments over the pod axis "
                         "too (multipod only)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose step is traced")
    ap.add_argument("--no-seqpar", action="store_true",
                    help="keep the train and prefill activations whole "
                         "over 'model' between blocks")
    ap.add_argument("--ring", action="store_true",
                    help="ring attention on the sequence slices (train "
                         "and prefill)")
    ap.add_argument("--ws-decode", action="store_true",
                    help="weight-stationary decode: no batch axes, the "
                         "activations cut along embed over 'data', the "
                         "FSDP weights never gathered")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    archs = ASSIGNED if args.arch == "all" else args.arch.split(",")
    shapes = (list(INPUT_SHAPES) if args.shape == "all"
              else args.shape.split(","))
    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[args.mesh]
    overrides = parse_overrides(args.override)

    os.makedirs(args.outdir, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multipod" if mp else "pod"
                stem = f"{arch}__{shape}__{mesh_name}"
                if args.tag:
                    stem += f"__{args.tag}"
                t0 = time.perf_counter()
                try:
                    res = run_pair(arch, shape, mp,
                                   microbatches=args.microbatches,
                                   scheme=args.scheme,
                                   attn_impl=args.attn_impl, tag=args.tag,
                                   overrides=overrides or None,
                                   zero_pod=args.zero_pod, rank=args.rank,
                                   seq_parallel=not args.no_seqpar,
                                   ring=args.ring,
                                   ws_decode=args.ws_decode)
                except Exception as e:  # noqa: BLE001 — recorded, not hidden
                    res = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc()[-3000:]}
                    failures += 1
                res["wall_s"] = round(time.perf_counter() - t0, 1)
                with open(os.path.join(args.outdir, stem + ".json"), "w") as f:
                    json.dump(res, f, indent=1)
                status = res["status"]
                extra = ""
                if status == "ok":
                    mem = res["memory"]["peak_bytes"] / 1e9
                    r = res["roofline"]
                    extra = (f" peak={mem:.2f}GB fits={res['fits']}"
                             f" trace={res['trace_s']}s"
                             f" bottleneck={r['bottleneck']}"
                             f" useful={r['useful_frac']:.2f}")
                elif status == "unsupported":
                    extra = f" {res['reason']}"
                print(f"[{status:>11}] {stem}{extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} pair(s) failed")


if __name__ == "__main__":
    main()
