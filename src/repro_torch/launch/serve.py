"""Serving launcher: the continuous-batching engine over the paged KV
cache (port of ``repro.launch.serve``).

Serves ``--requests`` prompts drawn with numpy from ``default_rng(0)``,
as the JAX launcher draws them, through ``serving.Engine`` (admission →
prefill → paged decode → sampling) and prints the same report: tokens per
second, engine steps, preemptions, the KV pool and its overhead over the
theoretical minimum (the paper's memory metric), and each of the first
requests' time to first token.  ``--no-paged`` serves from the contiguous
baseline (the paper's comparison), ``--pool-tokens`` sizes the page pool
below ``max_slots × max_seq_len`` (the paper's memory gain).  It runs on
the card (K4 for the prefill, K1 and K2 for every decode step) unless
``--device cpu`` is given, and the weights are f32, drawn from seed 0.

Usage:
  python -m repro_torch.launch.serve --arch llama2-7b --requests 8
  python -m repro_torch.launch.serve --arch granite-8b --smoke --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.serving import Engine, Request


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-seq-len", type=int, default=256)
    ap.add_argument("--pool-tokens", type=int, default=None,
                    help="oversubscribe the page pool (paper's memory win)")
    ap.add_argument("--no-paged", action="store_true",
                    help="contiguous baseline (the paper's comparison)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def make_requests(cfg: ModelConfig, n: int, max_seq_len: int, max_new: int,
                  temperature: float = 0.0
                  ) -> Tuple[List[Request], List[Optional[Dict]]]:
    """The JAX launcher's ``n`` requests: prompt lengths in [4, max_seq_len
    - max_new), tokens below min(vocab, 256), and the per-request image
    or audio stubs, drawn in its order from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    reqs, extras = [], []
    for _ in range(n):
        plen = int(rng.integers(4, max_seq_len - max_new))
        prompt = rng.integers(0, min(cfg.vocab_size, 256),
                              size=plen).tolist()
        reqs.append(Request(prompt=prompt, max_new_tokens=max_new,
                            temperature=temperature))
        extra = None
        if cfg.family == "vlm":
            extra = {"image_embeds": rng.standard_normal(
                (cfg.n_image_tokens, cfg.d_vision), np.float32)}
        elif cfg.family == "encdec":
            extra = {"frames": rng.standard_normal(
                (cfg.n_audio_frames, cfg.d_model), np.float32)}
        extras.append(extra)
    return reqs, extras


def serve(cfg: ModelConfig, params: Optional[Dict] = None, *,
          requests: int = 8, max_new: int = 16, max_slots: int = 4,
          max_seq_len: int = 256, pool_tokens: Optional[int] = None,
          paged: bool = True, temperature: float = 0.0, device="cuda",
          log_fn: Callable[[str], None] = print):
    """Serve ``make_requests``' prompts with ``params`` (drawn in f32 from
    seed 0 when None) and log the report.  Returns (the engine, the
    requests, the report's numbers)."""
    eng = Engine(cfg, params, max_slots=max_slots, max_seq_len=max_seq_len,
                 pool_tokens=pool_tokens, paged=paged, device=device)
    reqs, extras = make_requests(cfg, requests, max_seq_len, max_new,
                                 temperature)
    t0 = time.perf_counter()
    eng.generate(reqs, extras=extras)
    wall = time.perf_counter() - t0
    total_new = sum(len(r.output) for r in reqs)
    mr = eng.memory_report()
    report = {"requests": requests, "tokens": total_new, "wall_s": wall,
              "tok_s": total_new / wall, "steps": eng.steps,
              "preemptions": eng.scheduler.preempted,
              "pool_mib": mr["pool_bytes"] / 2**20,
              "overhead_frac": mr["overhead_frac"],
              "ttft_s": [r.metrics.get("ttft_s", -1) for r in reqs]}
    log_fn(f"\n{requests} requests, {total_new} tokens in {wall:.1f}s "
           f"({report['tok_s']:.1f} tok/s aggregate)")
    log_fn(f"engine steps: {eng.steps}  preemptions: "
           f"{eng.scheduler.preempted}")
    log_fn(f"kv pool {report['pool_mib']:.1f} MiB; overhead vs "
           f"theoretical min: {mr['overhead_frac']*100:.1f}%")
    for r in reqs[:4]:
        log_fn(f"  req {r.rid}: prompt {r.prompt_len} -> {len(r.output)} "
               f"new, ttft {r.metrics.get('ttft_s', -1):.3f}s")
    return eng, reqs, report


def main(argv: Optional[Sequence[str]] = None):
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return serve(cfg, requests=args.requests, max_new=args.max_new,
                 max_slots=args.max_slots, max_seq_len=args.max_seq_len,
                 pool_tokens=args.pool_tokens, paged=not args.no_paged,
                 temperature=args.temperature, device=args.device)


if __name__ == "__main__":
    main()
