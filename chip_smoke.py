#!/usr/bin/env python3
"""Drive the PyTorch port of the paged-attention server on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which fails the script (exit code 1) when it fails:

1. build: compile the CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and print the card's name and power limit;
2. kernels: each hand-written kernel — K1 paged decode partials, K2 split-K
   combine, K4 flex prefill — against its plain PyTorch version on the
   card, at the full-width llama2-7b shapes of the main path (H = Hkv =
   32, D = 128, page 64, batch 8, lens 256..2048, 2 pages per block, 4
   splits, prompts up to 1536) and on a small sweep (GQA, window,
   softcap, int8, D = 64), in f32 (tolerance 2e-5) and bf16 (2e-2), with
   |a - b| <= tol * (1 + |b|).  Times: kernel, plain version, the bound
   the card sets, and one PyTorch library call for the same function;
3. model: llama2-7b widths at 4 layers in f32: prefill and 3 decode
   steps through the kernels agree with the plain oracle path, and a
   smoke-size engine gives the same greedy tokens on both paths;
4. engine: full llama2-7b (32 layers, random weights from a seed, bf16)
   served by ``repro_torch.serving.Engine``: 8 slots, max_seq_len 2048,
   12 greedy requests with prompts of 256..1536 tokens and 32 new tokens
   each.  Kernel launch counts are reset just before and read just after;
   each of K1, K2, K4 must have launched.

The last two lines of standard output are the kernels JSON line and the
result line ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
and prints no result.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"

F32_TOL, BF16_TOL = 2e-5, 2e-2
MODEL_TOL = 1e-3  # f32 logits, 4 layers at d_model 4096: summation order
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, no tensor-core f32
SEED = 0


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def fmt(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def log(msg):
    print(msg, flush=True)


def nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError:
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else (
        "nvidia-smi unavailable")


def time_ms(torch, fn, reps=10, warmup=2):
    """Median milliseconds of ``fn`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, fn, kernel_name, reps=10):
    """Mean device time per call of the CUDA kernels whose name contains
    ``kernel_name``, from torch.profiler (None when it records none)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if kernel_name in ev.key:
            total_us += getattr(ev, "device_time_total",
                                getattr(ev, "cuda_time_total", 0.0))
    return total_us / 1e3 / reps if total_us > 0 else None


class Checker:
    def __init__(self, torch):
        self.torch = torch
        self.max_err = {}

    def close(self, kernel, what, got, want, tol):
        t = self.torch
        got, want = got.float(), want.float()
        if got.shape != want.shape:
            fail(f"{kernel} {what}: shape {tuple(got.shape)} != "
                 f"{tuple(want.shape)}")
        if not bool(t.isfinite(got).all()):
            fail(f"{kernel} {what}: non-finite values")
        err = (got - want).abs()
        bad = err > tol * (1 + want.abs())
        worst = float(err.max())
        self.max_err[kernel] = max(self.max_err.get(kernel, 0.0), worst)
        log(f"  {kernel:12s} {what:44s} max|err| {worst:.3e} "
            f"(|err| <= {tol:g} * (1 + |plain|))")
        if bool(bad.any()):
            fail(f"{kernel} {what}: max|err| {worst:.3e} beyond tol {tol}")


def paged_inputs(torch, gen, B, Hkv, G, D, P, max_pages, lens, dtype, dev,
                 int8=False, window=0):
    num_pages = B * max_pages + 3
    q = torch.randn((B, Hkv, G, D), generator=gen, device=dev).to(dtype)
    shape = (num_pages, P, Hkv, D)
    if int8:
        kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
        vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8)
    else:
        kp = torch.randn(shape, generator=gen, device=dev).to(dtype)
        vp = torch.randn(shape, generator=gen, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=gen, device=dev).int()
    tables = torch.full((B, max_pages), -1, dtype=torch.int32, device=dev)
    k = 0
    for b in range(B):
        n = max_pages if window else min(-(-int(lens[b]) // P), max_pages)
        tables[b, :n] = perm[k:k + n]
        k += n
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kp, vp, tables, lens_t


def kernel_phase(torch, chk):
    import torch.nn.functional as F
    from repro_torch.core import flex
    from repro_torch.kernels.flex_attention import flex_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rows = {}

    # -- K1 + K2 at the main-path shapes --------------------------------
    B, H, D, P, max_pages, ppb, ns = 8, 32, 128, 64, 32, 2, 4
    lens = torch.randint(256, 2049, (B,), generator=gen, device=dev).tolist()
    log(f"K1/K2 main path: B={B} H=Hkv={H} D={D} page={P} "
        f"max_pages={max_pages} ppb={ppb} splits={ns} lens={lens}")
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        q, kp, vp, tables, lens_t = paged_inputs(
            torch, gen, B, H, 1, D, P, max_pages, lens, dtype, dev)
        kw = dict(scale=D ** -0.5, pages_per_block=ppb, num_splits=ns)
        got = pa.paged_attention_partials(q, kp, vp, tables, lens_t, **kw)
        want = pa._paged_attention_partials_plain(
            q, kp, vp, tables, lens_t, window=0, softcap=0.0, kv_scale=0.0,
            **kw)
        torch.cuda.synchronize()
        for part, g_, w_ in zip("m l acc".split(), got, want):
            chk.close("paged_decode", f"{name} main {part}", g_, w_, tol)
        out_k = pa.combine_partials_kernel(*got, dtype=dtype)
        out_p = pa._combine_partials_plain(*got, dtype=dtype)
        torch.cuda.synchronize()
        chk.close("combine", f"{name} main (S={ns})", out_k, out_p, tol)

        k1_ms = time_ms(torch, lambda: pa.paged_attention_partials(
            q, kp, vp, tables, lens_t, **kw))
        k1_plain = time_ms(torch, lambda: pa._paged_attention_partials_plain(
            q, kp, vp, tables, lens_t, window=0, softcap=0.0, kv_scale=0.0,
            **kw), reps=5)
        k2_ms = time_ms(torch, lambda: pa.combine_partials_kernel(
            *got, dtype=dtype))
        k2_plain = time_ms(torch, lambda: pa._combine_partials_plain(
            *got, dtype=dtype))
        # library yardstick: SDPA over pre-gathered contiguous KV, which
        # computes K1 + K2 together (the gather is not timed)
        L = max(lens)
        safe = tables.clamp(min=0).long()
        kc = kp[safe].reshape(B, max_pages * P, H, D)[:, :L].transpose(1, 2)
        vc = vp[safe].reshape(B, max_pages * P, H, D)[:, :L].transpose(1, 2)
        kc, vc = kc.contiguous(), vc.contiguous()
        keep = (torch.arange(L, device=dev)[None, :] < lens_t[:, None]
                ).reshape(B, 1, 1, L)
        qs = q.reshape(B, H, 1, D)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kc, vc, attn_mask=keep))
        item = q.element_size()
        live = sum(lens)
        k1_bytes = (2 * live * H * D * item + q.numel() * item
                    + tables.numel() * 4 + B * 4
                    + sum(t.numel() * 4 for t in got))
        k1_ops = 4 * live * H * D
        k1_bound = 1e3 * max(k1_bytes / HBM_BPS, k1_ops / PEAK_OPS[name])
        k2_bytes = sum(t.numel() * 4 for t in got) + out_k.numel() * item
        k2_bound = 1e3 * max(k2_bytes / HBM_BPS,
                             4 * got[2].numel() / PEAK_OPS[name])
        k1_dev = device_ms(torch, lambda: pa.paged_attention_partials(
            q, kp, vp, tables, lens_t, **kw), "paged_decode_kernel")
        k2_dev = device_ms(torch, lambda: pa.combine_partials_kernel(
            *got, dtype=dtype), "combine_kernel")
        log(f"  paged_decode {name}: kernel {k1_ms:.4f} ms (device "
            f"{fmt(k1_dev)}), plain {k1_plain:.4f} ms, bound "
            f"{k1_bound:.4f} ms (bytes), SDPA over pre-gathered KV (K1+K2) "
            f"{lib:.4f} ms")
        log(f"  combine      {name}: kernel {k2_ms:.4f} ms (device "
            f"{fmt(k2_dev)}), plain {k2_plain:.4f} ms, bound "
            f"{k2_bound:.4f} ms (bytes)")
        rows[("paged_decode", name)] = dict(ms=k1_ms, device_ms=k1_dev,
                                            plain_ms=k1_plain,
                                            bound_ms=k1_bound,
                                            bound_by="bytes",
                                            library_ms=lib)
        rows[("combine", name)] = dict(ms=k2_ms, device_ms=k2_dev,
                                       plain_ms=k2_plain,
                                       bound_ms=k2_bound, bound_by="bytes",
                                       library_ms=None)
        del kp, vp, kc, vc

    # -- K1 + K2 sweep: GQA, window, softcap, int8, D=64 ------------------
    sweep = [  # (G, D, ppb, splits, window, softcap, int8)
        (4, 128, 2, 3, 0, 0.0, False),
        (8, 64, 1, 2, 0, 0.0, False),
        (2, 128, 2, 2, 100, 0.0, False),
        (1, 64, 1, 4, 0, 30.0, False),
        (4, 128, 2, 2, 0, 0.0, True),
        (1, 128, 4, 1, 0, 0.0, True),
    ]
    for G, Dd, sp_ppb, sp_ns, window, softcap, int8 in sweep:
        Bs, Hs, Ps = 3, 4, 16
        if window:
            ring = -(-window // Ps) + 1
            mp, slens = ring, [7, 150, 333]
        else:
            mp, slens = 9, [140, 17, 1]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            name = str(dtype).replace("torch.", "")
            q, kp, vp, tables, lens_t = paged_inputs(
                torch, gen, Bs, Hs, G, Dd, Ps, mp, slens, dtype, dev,
                int8=int8, window=window)
            kw = dict(scale=Dd ** -0.5, window=window, softcap=softcap,
                      kv_scale=0.05 if int8 else 0.0,
                      pages_per_block=sp_ppb, num_splits=sp_ns)
            got = pa.paged_attention_partials(q, kp, vp, tables, lens_t, **kw)
            want = pa._paged_attention_partials_plain(q, kp, vp, tables,
                                                      lens_t, **kw)
            tag = (f"{name} G{G} D{Dd} w{window} cap{softcap:g} "
                   f"{'int8' if int8 else ''}")
            for part, g_, w_ in zip("m l acc".split(), got, want):
                chk.close("paged_decode", f"{tag} {part}", g_, w_, tol)
            chk.close("combine", tag,
                      pa.combine_partials_kernel(*got, dtype=dtype),
                      pa._combine_partials_plain(*got, dtype=dtype), tol)

    # -- K4 at the main-path shapes --------------------------------------
    Bf, Hf, Q = 8, 32, 1536
    plens = torch.randint(256, Q + 1, (Bf,), generator=gen,
                          device=dev).tolist()
    plens[0] = Q
    log(f"K4 main path: B={Bf} H=Hkv={Hf} D={D} Q=K={Q} "
        f"mask causal & padding(lens={plens})")
    plens_t = torch.tensor(plens, dtype=torch.int32, device=dev)
    mm = flex.and_masks(flex.causal_mask, flex.padding_mask(plens_t))
    bm = flex.build_block_mask(mm, Q, Q, 128, 128, B=Bf, device=dev)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        name = str(dtype).replace("torch.", "")
        shape = (Bf, Hf, Q, D)
        q = torch.randn(shape, generator=gen, device=dev).to(dtype)
        k = torch.randn(shape, generator=gen, device=dev).to(dtype)
        v = torch.randn(shape, generator=gen, device=dev).to(dtype)
        kw = dict(scale=D ** -0.5, mask_mod=mm, q_len=Q, kv_len=Q)
        got = fa.flex_attention_kernel(q, k, v, bm, **kw)
        want = fa._flex_attention_plain(q, k, v, bm, **kw)
        torch.cuda.synchronize()
        chk.close("flex_prefill", f"{name} main causal&padding", got, want,
                  tol)
        k4_ms = time_ms(torch, lambda: fa.flex_attention_kernel(
            q, k, v, bm, **kw), reps=5)
        k4_plain = time_ms(torch, lambda: fa._flex_attention_plain(
            q, k, v, bm, **kw), reps=3, warmup=1)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=5)
        pairs = sum(min(qq + 1, L) for L in plens for qq in range(Q))
        ops = 4 * D * Hf * pairs
        nbytes = 4 * q.numel() * q.element_size()
        k4_bound = 1e3 * max(nbytes / HBM_BPS, ops / PEAK_OPS[name])
        k4_dev = device_ms(torch, lambda: fa.flex_attention_kernel(
            q, k, v, bm, **kw), "flex_fwd_kernel", reps=3)
        log(f"  flex_prefill {name}: kernel {k4_ms:.3f} ms (device "
            f"{fmt(k4_dev)}), plain {k4_plain:.3f} ms, bound {k4_bound:.4f} "
            f"ms (operations), SDPA causal (no padding mask) {lib:.3f} ms")
        rows[("flex_prefill", name)] = dict(ms=k4_ms, device_ms=k4_dev,
                                            plain_ms=k4_plain,
                                            bound_ms=k4_bound,
                                            bound_by="operations",
                                            library_ms=lib)
        del q, k, v, got, want

    # -- K4 sweep: ragged tiles, GQA, D=64, every mask variant -----------
    cases = [  # (B, H, Hkv, Q, D, mask, q_block, kv_block)
        (2, 4, 2, 200, 64, "causal&padding", 128, 128),
        (3, 8, 2, 77, 128, "causal&padding", 128, 128),
        (2, 4, 4, 130, 128, "causal", 48, 32),
        (2, 2, 1, 96, 64, "padding", 40, 56),
        (1, 2, 2, 33, 128, "full", 16, 16),
    ]
    for Bs, Hs, Hk, Qs, Dd, mname, qb, kb in cases:
        sl = torch.randint(1, Qs + 1, (Bs,), generator=gen, device=dev)
        mods = {"causal": flex.causal_mask, "full": flex.full_mask,
                "padding": flex.padding_mask(sl),
                "causal&padding": flex.and_masks(flex.causal_mask,
                                                 flex.padding_mask(sl))}
        mod = mods[mname]
        for dtype, tol in ((torch.float32, F32_TOL),
                           (torch.bfloat16, BF16_TOL)):
            name = str(dtype).replace("torch.", "")
            from repro_torch.kernels.flex_attention.ops import flex_attention
            q = torch.randn((Bs, Hs, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((Bs, Hk, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((Bs, Hk, Qs, Dd), generator=gen,
                            device=dev).to(dtype)
            got = flex_attention(q, k, v, mask_mod=mod, q_block=qb,
                                 kv_block=kb)
            qbb, kbb = min(qb, Qs), min(kb, Qs)
            if mod is flex.causal_mask:
                bms = flex.causal_block_mask(Qs, Qs, qbb, kbb, device=dev)
            else:
                bms = flex.build_block_mask(
                    mod, Qs, Qs, qbb, kbb,
                    B=Bs if isinstance(mod, flex.AuxMod) else None,
                    device=dev)
            pq, pk = -Qs % qbb, -Qs % kbb
            want = fa._flex_attention_plain(
                F.pad(q, (0, 0, 0, pq)), F.pad(k, (0, 0, 0, pk)),
                F.pad(v, (0, 0, 0, pk)), bms, scale=Dd ** -0.5,
                mask_mod=mod, q_len=Qs, kv_len=Qs)[:, :, :Qs]
            chk.close("flex_prefill",
                      f"{name} B{Bs} H{Hs}/{Hk} Q{Qs} D{Dd} {mname} "
                      f"tiles {qbb}x{kbb}", got, want, tol)
    return rows


def model_phase(torch):
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import Engine, Request

    dev = torch.device("cuda")
    cfg = get_config("llama2-7b").replace(n_layers=4)
    model = build_model(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    params = model.init_params(gen, torch.float32, dev)
    lens = [100, 257, 384, 512]
    B, P, pps = len(lens), cfg.page_size, 16
    S = max(lens)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    num_pages = B * pps + 4
    perm = torch.randperm(num_pages, generator=gen, device=dev).int()
    tables = perm[:B * pps].reshape(B, 1, pps).contiguous()
    pool = (cfg.n_layers, num_pages, P, cfg.n_kv_heads, cfg.resolved_head_dim)
    worst = 0.0
    outs = {}
    for impl in ("kernel", "ref"):
        st = {"pos": lens_t, "tables": tables,
              "k_pages": torch.zeros(pool, device=dev),
              "v_pages": torch.zeros(pool, device=dev)}
        logits, st = model.prefill(params, tokens, st, lens=lens_t,
                                   impl=impl)
        seq = [logits]
        nxt = logits.argmax(-1)
        for _ in range(3):
            logits, st = model.decode_step(params, nxt, st, impl=impl)
            seq.append(logits)
            nxt = logits.argmax(-1)
        outs[impl] = torch.stack(seq)
    torch.cuda.synchronize()
    got, want = outs["kernel"], outs["ref"]
    if not bool(torch.isfinite(got).all()):
        fail("model phase: non-finite logits")
    worst = float((got - want).abs().max())
    log(f"model phase (llama2-7b widths, 4 layers, f32): prefill + 3 decode "
        f"logits, kernel path vs plain path max|err| {worst:.3e} "
        f"(tol {MODEL_TOL:g}, |logit| max {float(want.abs().max()):.3f})")
    if worst > MODEL_TOL:
        fail(f"model phase: max|err| {worst} beyond {MODEL_TOL}")
    del params, outs

    # greedy tokens, kernel path vs plain path, on a smoke-size engine
    scfg = get_config("llama2-7b").smoke()
    rng = torch.Generator().manual_seed(SEED)
    prompts = [torch.randint(0, scfg.vocab_size, (int(n),),
                             generator=rng).tolist()
               for n in torch.randint(8, 100, (6,), generator=rng)]
    toks = {}
    for impl in ("kernel", "ref"):
        eng = Engine(scfg, max_slots=4, max_seq_len=128, pool_tokens=320,
                     impl=impl, seed=SEED, num_splits=2, pages_per_block=2)
        reqs = [Request(prompt=list(p), max_new_tokens=8) for p in prompts]
        eng.generate(reqs)
        toks[impl] = [r.output for r in reqs]
    if toks["kernel"] != toks["ref"]:
        fail(f"smoke engine: kernel tokens {toks['kernel']} != plain "
             f"{toks['ref']}")
    log(f"smoke engine: greedy tokens equal on both paths "
        f"({sum(len(t) for t in toks['kernel'])} tokens)")


def engine_phase(torch):
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, Request, Status

    cfg = get_config("llama2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(cfg, max_slots=8, max_seq_len=2048, dtype=torch.bfloat16,
                 seed=SEED)
    torch.cuda.synchronize()
    log(f"engine phase: llama2-7b, {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, bf16, 8 slots, max_seq_len 2048, pool "
        f"{eng.num_pages} pages of {cfg.page_size}; weights and pools "
        f"ready in {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator().manual_seed(SEED)
    n_req, new = 12, 32
    plens = torch.randint(256, 1537, (n_req,), generator=rng).tolist()
    reqs = [Request(prompt=torch.randint(0, cfg.vocab_size, (n,),
                                         generator=rng).tolist(),
                    max_new_tokens=new) for n in plens]
    for r in reqs:
        eng.add_request(r)

    kernels.reset_launch_counts()
    decode_ms, prefill_ms = [], []
    t0 = time.perf_counter()
    for _ in range(10_000):
        if all(r.done for r in reqs):
            break
        before = kernels.launch_counts()["flex_prefill"]
        s0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - s0)
        (prefill_ms if kernels.launch_counts()["flex_prefill"] > before
         else decode_ms).append(dt)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()

    bad = [r.rid for r in reqs
           if r.status is not Status.FINISHED or len(r.output) != new]
    if bad:
        fail(f"engine: requests {bad} did not finish with {new} tokens "
             f"(failed: {[str(r.error) for r in reqs if r.error]})")
    if eng.scheduler.failed:
        fail("engine: the numerics guard failed a request (non-finite "
             "logits)")
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        fail(f"engine: kernels never launched on the main path: {missing}")
    ttft = sorted(r.metrics["ttft_s"] for r in reqs)
    new_tokens = sum(len(r.output) for r in reqs)
    stats = dict(
        requests=n_req, prompt_lens=plens, new_tokens=new_tokens,
        wall_s=wall, tok_s=new_tokens / wall,
        ttft_s_p50=ttft[len(ttft) // 2], ttft_s_max=ttft[-1],
        decode_ms_per_step_median=statistics.median(decode_ms),
        decode_steps=len(decode_ms), prefill_steps=len(prefill_ms),
        prefill_ms_per_step=prefill_ms,
        preempted=eng.scheduler.preempted,
        max_memory_allocated_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts)
    log(f"engine: {new_tokens} tokens in {wall:.2f} s = "
        f"{stats['tok_s']:.1f} tok/s; TTFT p50 {stats['ttft_s_p50']:.3f} s "
        f"max {stats['ttft_s_max']:.3f} s; decode "
        f"{stats['decode_ms_per_step_median']:.2f} ms/step (median of "
        f"{len(decode_ms)}), prefill steps {[round(x) for x in prefill_ms]} "
        f"ms; preemptions {eng.scheduler.preempted}; "
        f"max_memory_allocated {stats['max_memory_allocated_gb']:.2f} GB; "
        f"launches {counts}")

    # where the time goes: a profiled follow-up wave (after the launch
    # counts were read): the step admitting 8 prompts of 1024 tokens
    # (their prefill plus their first decode), then 3 decode steps
    for _ in range(8):
        eng.add_request(Request(prompt=torch.randint(
            0, cfg.vocab_size, (1024,), generator=rng).tolist(),
            max_new_tokens=8))
    stats["profile_prefill_step"] = profile_steps(torch, eng, 1)
    stats["profile_decode_step"] = profile_steps(torch, eng, 3)
    for name in ("prefill_step", "decode_step"):
        prof = stats["profile_" + name]
        log(f"profile {name}: wall {prof['wall_ms']:.2f} ms/step, device "
            f"busy {fmt(prof['device_ms'])} ({prof['busy_share']}); "
            f"device ms/step by kind {prof['by_kind']}")
    return stats


KINDS = (("K1 paged_decode", ("paged_decode_kernel",)),
         ("K2 combine", ("combine_kernel",)),
         ("K4 flex_prefill", ("flex_fwd_kernel",)),
         ("matmul", ("gemm", "gemv", "nvjet", "cutlass", "xmma")))


def profile_steps(torch, eng, n):
    """Device time per engine step by kernel kind, and the device's busy
    share of the step's wall time, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    by_kind = {k: 0.0 for k, _ in KINDS}
    by_kind["other"] = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        kind = next((k for k, keys in KINDS
                     if any(x in ev.key for x in keys)), "other")
        by_kind[kind] += us / 1e3 / n
    busy = sum(by_kind.values())
    return dict(wall_ms=wall_ms, device_ms=busy if busy > 0 else None,
                busy_share=(f"{busy / wall_ms:.3f} of wall" if busy > 0
                            else "not measured"),
                by_kind={k: round(v, 4) for k, v in by_kind.items()})


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 parity needs IEEE
    torch.backends.cudnn.allow_tf32 = False

    smi = nvidia_smi()
    log(smi)
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    build.get_lib()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {build.build_seconds:.1f} s)")

    chk = Checker(torch)
    rows = kernel_phase(torch, chk)
    model_phase(torch)
    torch.cuda.empty_cache()
    engine = engine_phase(torch)

    src = "src/repro_torch/csrc/"
    meta = {
        "paged_decode": ("paged_decode.cu", "src/repro/kernels/"
                         "paged_attention/paged_attention.py:223"),
        "combine": ("combine.cu", "src/repro/kernels/paged_attention/"
                    "paged_attention.py:161"),
        "flex_prefill": ("flex_prefill.cu", "src/repro/kernels/"
                         "flex_attention/flex_attention.py:38"),
    }
    kernels_line = []
    for name, (fname, replaces) in meta.items():
        r = rows[(name, "bfloat16")]
        kernels_line.append(dict(
            name=name, route="cuda", source=src + fname, replaces=replaces,
            launches=engine["launches"][name],
            max_abs_err=chk.max_err[name], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke_last.json").write_text(json.dumps(
        {"nvidia_smi": smi, "kernels": kernels_line,
         "times": {f"{k}/{d}": v for (k, d), v in rows.items()},
         "max_abs_err": chk.max_err, "engine": engine}, indent=1))
    log(nvidia_smi())
    print(json.dumps({"kernels": kernels_line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
