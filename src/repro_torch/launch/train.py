"""Training launcher (port of ``repro.launch.train``).

Trains a config on synthetic next-token batches (``data.synthetic_batches``)
in f32 through the train plan and its step, as the JAX launcher does:
``plan_for`` picks the batch axes, the microbatches (per-rank f32 logits
under 256 MB) and the layout, and ``build_step`` builds the step
(``launch.steps.build_train_step``).  The attention is the plain dense
path under ``--smoke`` (the reduced config) and the chunked online
softmax otherwise, as the JAX launcher chooses.  It runs on the local 1 x
1 mesh unless ``--production-mesh`` is given: then on the 16 x 16 mesh
(``launch.mesh.make_production_mesh``), one process per GPU started by
``torchrun`` (NCCL on the card, gloo on the CPU), each rank on its own
device, holding its pieces of the params and its rows of each batch.  It
runs on the card unless ``--device cpu`` is given.  The step takes
``--lr``, 3e-4 by default: the rate at which the JAX launcher's step
always runs.

Usage:
  python -m repro_torch.launch.train --arch granite-8b --smoke --steps 200
  python -m repro_torch.launch.train --arch llama2-7b --smoke --steps 3 \\
      --device cpu
  torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \\
      --arch llama2-7b --production-mesh --batch 256 --seq 4096
"""

from __future__ import annotations

import argparse
import math
import os
from typing import Callable, Optional, Sequence

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data import synthetic_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.steps import build_step, plan_for, shard_batch
from repro_torch.training.checkpoint import save
from repro_torch.training.loop import train_loop
from repro_torch.training.state import TrainState


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 mesh: 256 ranks started by torchrun")
    ap.add_argument("--checkpoint", default="",
                    help=".npz path for the trained params (rank 0's)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float,
          impl: str, device="cuda", log_every: int = 10,
          log_fn: Callable[[str], None] = print, on_step=None, mesh=None):
    """``steps`` AdamW steps of ``cfg`` under its train plan on ``mesh``
    (the local mesh by default), from f32 params seeded by 0 (each rank
    keeps its pieces) on ``synthetic_batches(batch, seq, vocab, seed=0)``
    (each rank takes its rows).  Returns ``train_loop``'s (state,
    history)."""
    mesh = mesh or make_local_mesh()
    run = RunConfig(model=cfg, seq_len=seq, global_batch=batch, kind="train")
    plan = plan_for(run, mesh, attn_impl=impl)
    step, _, _, model = build_step(run, plan, torch.float32, lr=lr)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    many = math.prod(mesh.shape) > 1
    state = TrainState.create(model.init_params(
        gen, torch.float32, device, plan=plan if many else None))
    data = synthetic_batches(batch, seq, cfg.vocab_size, cfg=cfg)
    return train_loop(model, data, steps=steps, lr=lr, log_every=log_every,
                      log_fn=log_fn, impl=impl, state=state,
                      on_step=on_step,
                      step_fn=lambda st, b: step(st, shard_batch(b, plan)))


def _production_mesh(device: str):
    """Join the process group ``torchrun`` describes and build the 16 x 16
    mesh; returns (the mesh, this rank's device)."""
    import torch.distributed as dist
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group("nccl" if cuda else "gloo")
    if cuda:
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local)
        device = f"cuda:{local}"
    return make_production_mesh(), device


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    mesh, device, log_fn = None, args.device, print
    if args.production_mesh:
        mesh, device = _production_mesh(args.device)
        if mesh.rank:
            log_fn = lambda s: None  # noqa: E731 — rank 0 logs
    state, history = train(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr,
                           impl="ref" if args.smoke else "chunked",
                           device=device, log_every=args.log_every,
                           log_fn=log_fn, mesh=mesh)
    if args.checkpoint and not (mesh and mesh.rank):
        save(args.checkpoint, state.params)
        print("saved", args.checkpoint)
    return state, history


if __name__ == "__main__":
    main()
