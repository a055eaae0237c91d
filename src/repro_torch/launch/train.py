"""Training launcher (port of ``repro.launch.train`` on one device).

Trains a config on synthetic next-token batches (``data.synthetic_batches``)
in f32 through ``training.train_loop``: the plain dense attention under
``--smoke`` (the reduced config), the chunked online softmax otherwise,
as the JAX launcher chooses.  It runs on the card unless ``--device cpu``
is given.  The production mesh and microbatching wait for the port's
``distributed/`` and ``launch/steps.py``.  The step takes ``--lr``, 3e-4
by default: the rate at which the JAX launcher's step always runs.

Usage:
  python -m repro_torch.launch.train --arch granite-8b --smoke --steps 200
  python -m repro_torch.launch.train --arch llama2-7b --smoke --steps 3 \\
      --device cpu
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import synthetic_batches
from repro_torch.models.api import build_model
from repro_torch.training.checkpoint import save
from repro_torch.training.loop import train_loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint", default="",
                    help=".npz path for the trained params")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int, lr: float,
          impl: str, device="cuda", log_every: int = 10,
          log_fn: Callable[[str], None] = print, on_step=None):
    """``steps`` AdamW steps of ``cfg`` from f32 params seeded by 0 on
    ``synthetic_batches(batch, seq, vocab, seed=0)``.  Returns
    ``train_loop``'s (state, history)."""
    model = build_model(cfg)
    data = synthetic_batches(batch, seq, cfg.vocab_size, cfg=cfg)
    return train_loop(model, data, steps=steps, lr=lr, log_every=log_every,
                      log_fn=log_fn, impl=impl, device=device,
                      on_step=on_step)


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    state, history = train(cfg, steps=args.steps, batch=args.batch,
                           seq=args.seq, lr=args.lr,
                           impl="ref" if args.smoke else "chunked",
                           device=args.device, log_every=args.log_every)
    if args.checkpoint:
        save(args.checkpoint, state.params)
        print("saved", args.checkpoint)
    return state, history


if __name__ == "__main__":
    main()
