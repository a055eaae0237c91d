"""Serving engine: continuous batching over the paged KV cache (port of
``repro.serving.engine``: paged prefill, monolithic or chunked, the
global prefix cache, and decode).

The model's prefill and decode steps run against global K/V page pools on
the device, updated in place; the scheduler's host-side page manager
decides admission and preemption, and the block tables are shipped to
the device every step.  ``impl="kernel"`` (the default) runs monolithic
prefill attention through the flex kernel (K4), chunked prefill and
prefix-cache resumes through the chunked paged prefill kernel (K3), and
decode through the split-K paged kernel (K1) and its combine (K2);
``impl="ref"`` runs the plain oracles.

One Engine serves one model on ``max_slots`` logical slots.  The pool may
be oversubscribed (``pool_tokens < max_slots × max_seq_len``): that is
the paper's memory win over max-length pre-allocation, and preemption
(recompute) keeps the batch moving when it runs dry.

``prefill_chunk`` bounds each step's prefill work: the PREFILLING rows
share one global budget of ``prefill_chunk`` tokens per step, interleaved
with the decode of the RUNNING rows.  ``prefix_cache=True`` shares the
full pages of a common prompt head across requests (``core.prefix_cache``):
admission attaches to the longest cached prefix and prefill runs only the
suffix; it refuses windowed models, as the JAX engine does (their ring
pages are overwritten in place).  Recurrent (``R``) layers refuse
``prefill_chunk`` and ``prefix_cache``, as in the JAX engine; their state
lives per slot (``state["rec"]``), is written for the admitted slots
after each monolithic prefill and stepped by every decode.  The JAX
engine's gate on cross-attention holds here because ``build_model``
builds no cross-attention layers.

Sliding-window (``W``) layers keep their K/V in a ring of ``ceil(window
/ P) + 1`` pages, the first columns of each table row.  When every
attention layer is ``W`` (no ``A`` layer), the device tables are only
ring-wide, and a host row longer than the ring is truncated by design;
as in the JAX engine, the host page manager still reserves a page for
every token of a request, so a pool must hold the requests' full lengths
all the same.

Not ported yet (raise ``UnsupportedFeature``): fault injection,
``fork_request`` and the contiguous baseline (``paged=False``).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paging import HostPageManager
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.device import resolve_device
from repro_torch.errors import (EngineConfigError, EngineError,
                                InternalError, NumericsError, RequestTooLong,
                                SchedulerInvariantError, UnsupportedFeature)
from repro_torch.kernels import check_impl
from repro_torch.models.api import build_model
from repro_torch.models.attention import kv_pool_dtype
from repro_torch.serving.request import Request, Status
from repro_torch.serving.sampler import (SampleParams, sample,
                                         validate_sample_params)
from repro_torch.serving.scheduler import Scheduler

class Engine:
    def __init__(
        self,
        cfg: ModelConfig,
        params: Optional[Dict] = None,
        *,
        max_slots: int = 8,
        max_seq_len: int = 512,
        pool_tokens: Optional[int] = None,  # None => slots*max_seq_len
        paged: Optional[bool] = None,
        impl: str = "kernel",
        seed: int = 0,  # weight init (when params is None) and sampling
        dtype=torch.float32,
        device="cuda",
        pages_per_block: Optional[int] = None,  # decode kernel knobs;
        num_splits: Optional[int] = None,  # None → auto-tuned per shape
        prefill_chunk: Optional[int] = None,  # prompt tokens prefilled per
        # step across the PREFILLING rows (None = whole prompts at once)
        prefix_cache: bool = False,  # radix-indexed page sharing
        faults=None,
    ):
        if faults is not None:
            raise UnsupportedFeature("faults is not ported yet",
                                     feature="faults")
        if not (cfg.paged_attention if paged is None else paged):
            raise UnsupportedFeature("the contiguous baseline (paged=False) "
                                     "is not ported yet", feature="paged")
        recurrent = any(c in "RMS" for c in cfg.pattern())
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise EngineConfigError(
                    "prefill_chunk must be >= 1 (or None)",
                    prefill_chunk=prefill_chunk)
            if recurrent:
                raise EngineConfigError(
                    "chunked prefill does not support recurrent layers "
                    f"(pattern {cfg.layer_pattern!r}): their prefill state "
                    "replay assumes the whole prompt",
                    pattern=cfg.layer_pattern)
        check_impl(impl)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        if prefix_cache and self.model.window > 0:
            raise EngineConfigError(
                "prefix_cache requires window=0: windowed layers overwrite "
                "their ring pages in place, so cached pages shared from a "
                "live donor would be mutated", window=self.model.window)
        if prefix_cache and recurrent:
            raise EngineConfigError(
                "prefix_cache does not support recurrent layers (pattern "
                f"{cfg.layer_pattern!r}): their state is not "
                "page-addressed", pattern=cfg.layer_pattern)
        self.impl = impl
        self.prefill_chunk = prefill_chunk
        self.pages_per_block = pages_per_block
        self.num_splits = num_splits
        self.dtype = dtype
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(seed)
            params = self.model.init_params(init_gen, dtype, self.device)
        self.params = params
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed + 1)

        ps = cfg.page_size
        window = self.model.window
        # ring-sized tables are sound only when EVERY attention layer is
        # windowed: a mixed pattern's 'A' layers carry live KV for the
        # whole sequence (its 'W' layers use columns 0..ring-1 as the ring)
        self._ring_tables = window > 0 and "A" not in cfg.pattern()
        ring = -(-window // ps) + 1
        if self._ring_tables:
            self.pages_per_seq = ring
        elif window > 0:
            self.pages_per_seq = max(-(-max_seq_len // ps), ring)
        else:
            self.pages_per_seq = -(-max_seq_len // ps)
        if pool_tokens is None:
            num_pages = max_slots * self.pages_per_seq
        else:
            num_pages = max(-(-pool_tokens // ps), self.pages_per_seq)
        self.num_pages = num_pages
        self.mgr = HostPageManager(num_pages, ps)
        self.prefix_cache = PrefixCache(self.mgr) if prefix_cache else None
        self.scheduler = Scheduler(self.mgr, max_slots, max_seq_len,
                                   prefill_chunk=prefill_chunk,
                                   prefix_cache=self.prefix_cache)
        self.state = self._init_state()
        self.steps = 0

    # ------------------------------------------------------------------
    def _init_state(self) -> Dict:
        cfg = self.cfg
        pool = (self.model.n_attn_layers, self.num_pages, cfg.page_size,
                cfg.n_kv_heads, cfg.resolved_head_dim)
        pool_dt = kv_pool_dtype(cfg, self.dtype)
        st = {
            "pos": torch.zeros((self.max_slots,), dtype=torch.int32,
                               device=self.device),
            "k_pages": torch.zeros(pool, dtype=pool_dt, device=self.device),
            "v_pages": torch.zeros(pool, dtype=pool_dt, device=self.device),
        }
        rec = self.model.init_rec_state(self.max_slots, self.dtype,
                                        self.device)
        if rec is not None:  # recurrent state slots
            st["rec"] = rec
        return st

    # ------------------------------------------------------------------
    def add_request(self, req: Request) -> int:
        """Validate and enqueue ``req``.

        Raises structured errors before the request holds any resources:
        ``InvalidRequest`` (bad sampling params) or ``RequestTooLong``
        (prompt + budget exceeds max_seq_len).
        """
        validate_sample_params(req)
        if req.prompt_len + req.max_new_tokens > self.max_seq_len:
            raise RequestTooLong(
                f"request exceeds engine max_seq_len: prompt_len "
                f"{req.prompt_len} + max_new_tokens {req.max_new_tokens} > "
                f"{self.max_seq_len}", rid=req.rid,
                limit=self.max_seq_len)
        req.metrics["t_arrive"] = time.perf_counter()
        req.metrics["step_arrive"] = self.steps
        self.scheduler.add(req)
        return req.rid

    def generate(self, reqs: List[Request],
                 max_steps: int = 100_000) -> List[Request]:
        """Blocking helper: run until the given requests all finish."""
        for r in reqs:
            self.add_request(r)
        for _ in range(max_steps):
            if all(r.done for r in reqs):
                break
            self.step()
        return reqs

    # ------------------------------------------------------------------
    def step(self) -> List[Request]:
        """One engine iteration: deadlines → admit → prefill → decode →
        sample → finish.  Returns requests that reached a terminal state
        this step.  Anything unstructured is wrapped in ``InternalError``.
        """
        try:
            return self._step_impl()
        except EngineError:
            raise  # structured: the caller can route it
        except Exception as e:  # noqa: BLE001 — the wrap IS the contract
            raise InternalError(
                f"unstructured failure escaped engine step: {e!r}") from e

    def _step_impl(self) -> List[Request]:
        self.steps += 1
        self.scheduler.check_deadlines(self.steps)
        admitted = self.scheduler.admit()
        finished: List[Request] = []
        if self.prefill_chunk is None:
            if admitted:
                self._prefill(admitted)
                # prefill's sampled token may already hit EOS / max_new
                finished += self._finish_done()
        elif any(r.status is Status.PREFILLING
                 for r in self.scheduler.running.values()):
            # each PREFILLING row caches its share of one chunk budget;
            # rows whose last chunk lands sample their first token
            self._prefill_chunk_step()
            finished += self._finish_done()
        if self._any_running():
            self.scheduler.extend_for_decode()
            # extend may have failed the last decoder (starvation)
            if self._any_running():
                self._decode()
                finished += self._finish_done()
        finished += self._drain_failed()
        return finished

    def _any_running(self) -> bool:
        return any(r.status is Status.RUNNING
                   for r in self.scheduler.running.values())

    def _drain_failed(self) -> List[Request]:
        ev, self.scheduler.failed_events = self.scheduler.failed_events, []
        now = time.perf_counter()
        for r in ev:
            r.metrics.setdefault("t_done", now)
        return ev

    # ------------------------------------------------------------------
    def cancel_request(self, rid: int) -> bool:
        """Tear down request ``rid`` in any state (WAITING, RUNNING,
        PREEMPTED): pages and table row released.  Returns False for
        unknown or already-terminal requests."""
        req = self._find_request(rid)
        if req is None or not self.scheduler.cancel(req):
            return False
        req.metrics.setdefault("t_done", time.perf_counter())
        return True

    def _find_request(self, rid: int) -> Optional[Request]:
        for r in list(self.scheduler.waiting) + list(
                self.scheduler.running.values()):
            if r.rid == rid:
                return r
        return None

    def fork_request(self, src: Request, max_new_tokens: int = 64,
                     **sampling) -> Request:
        raise UnsupportedFeature("fork_request is not ported yet",
                                 rid=src.rid, feature="fork_request")

    # ------------------------------------------------------------------
    def _tables_np(self, decode: bool = False) -> np.ndarray:
        """Block tables for the batch (max_slots, 1, pages_per_seq), one
        row per live slot, -1 elsewhere.  ``decode=True`` leaves rows of
        slots that are not RUNNING at -1 (a PREFILLING row must neither
        receive the decode placeholder's K/V nor be attended over).  A row
        outgrowing the device table is a hard error (its KV tail would be
        dropped silently), except in a model whose every attention layer
        is windowed: its row is a ring, and ``row[:ring]`` IS the table
        (the ring slots are overwritten in place, so the host's extra
        pages never carry live data)."""
        pps = self.pages_per_seq
        t = np.full((self.max_slots, 1, pps), -1, np.int32)
        for slot, req in self.scheduler.running.items():
            if decode and req.status is not Status.RUNNING:
                continue
            row = self.mgr.tables.get(req.rid, [])
            if len(row) > pps and not self._ring_tables:
                raise SchedulerInvariantError(
                    f"request {req.rid} holds {len(row)} pages but the "
                    f"device block table is {pps} pages wide "
                    f"(max_seq_len={self.max_seq_len}); refusing to "
                    f"truncate its KV tail silently", rid=req.rid)
            t[slot, 0, :min(len(row), pps)] = row[:pps]
        return t

    def _tables_array(self, decode: bool = False) -> torch.Tensor:
        return torch.from_numpy(self._tables_np(decode)).to(self.device)

    def _prefill(self, admitted: List[Tuple[int, Request]]) -> None:
        """Prefill newly admitted requests (sub-batch padded to max len)."""
        slots = [s for s, _ in admitted]
        reqs = [r for _, r in admitted]
        if any(r.prefill_pos > 0 for r in reqs):
            # a row attached to cached prefix pages: the wave runs through
            # the chunk kernel, each row its un-cached suffix only
            self._prefill_from(slots, reqs)
            return
        toks = [r.prompt + r.output for r in reqs]  # preempted: re-prefill
        L = max(len(t) for t in toks)
        batch = np.zeros((len(reqs), L), np.int64)
        lens = np.zeros((len(reqs),), np.int32)
        for i, t in enumerate(toks):
            batch[i, :len(t)] = t
            lens[i] = len(t)
        idx = torch.as_tensor(slots, device=self.device)
        lens_t = torch.from_numpy(lens).to(self.device)
        st = self.state
        sub_state = {"pos": lens_t, "k_pages": st["k_pages"],
                     "v_pages": st["v_pages"],
                     "tables": self._tables_array()[idx, 0]}
        logits, new_st = self.model.prefill(
            self.params, torch.from_numpy(batch).to(self.device), sub_state,
            lens=lens_t, impl=self.impl)
        st["pos"][idx] = lens_t  # pools were written in place
        if "rec" in new_st:  # the admitted slots' recurrent state
            for code, tree in new_st["rec"].items():
                for k, v in tree.items():
                    st["rec"][code][k][:, idx] = v
        for i, r in enumerate(reqs):
            r.prefill_pos = int(lens[i])
        self._cache_insert_live(reqs)
        self._sample_and_append(reqs, logits, first=True)

    def _prefill_from(self, slots: List[int], reqs: List[Request]) -> None:
        """Monolithic prefill resuming past cached prefixes: each row runs
        its un-cached suffix (``q_start`` = matched tokens) through the
        chunk kernel, attending back over the shared pages through its
        block table (cold rows are ``q_start = 0``).  Reachable only with
        the prefix cache on."""
        toks = [r.prompt + r.output for r in reqs]
        starts = np.asarray([r.prefill_pos for r in reqs], np.int32)
        lens = np.asarray([len(t) for t in toks], np.int32)
        q_lens = lens - starts  # >= 1: attach caps the match at total-1
        B, C = len(reqs), int(q_lens.max())
        batch = np.zeros((B, C), np.int64)
        for i, t in enumerate(toks):
            batch[i, :q_lens[i]] = t[starts[i]:lens[i]]
        logits = self._run_chunk(slots, batch, starts, q_lens)
        for i, r in enumerate(reqs):
            r.prefill_pos = int(lens[i])
        self._cache_insert_live(reqs)
        self._sample_and_append(reqs, logits, first=True)

    def _run_chunk(self, slots: List[int], batch: np.ndarray,
                   starts: np.ndarray, q_lens: np.ndarray) -> torch.Tensor:
        """One ``prefill_chunk`` call over the rows of ``batch`` (rows past
        ``slots`` are dead padding); the live slots' positions advance to
        ``starts + q_lens``.  Returns each row's last-live-token logits."""
        n, B = len(slots), batch.shape[0]
        tables = np.full((B, self.pages_per_seq), -1, np.int32)
        tables[:n] = self._tables_np()[np.asarray(slots), 0]
        st = self.state
        sub_state = {"k_pages": st["k_pages"], "v_pages": st["v_pages"],
                     "tables": torch.from_numpy(tables).to(self.device)}
        q_start = torch.from_numpy(starts).to(self.device)
        q_len_t = torch.from_numpy(q_lens).to(self.device)
        logits, _ = self.model.prefill_chunk(
            self.params, torch.from_numpy(batch).to(self.device), sub_state,
            q_start=q_start, q_lens=q_len_t, impl=self.impl,
            pages_per_block=self.pages_per_block,
            num_splits=self.num_splits)
        idx = torch.as_tensor(slots, device=self.device)
        st["pos"][idx] = (q_start + q_len_t)[:n]  # pools written in place
        return logits

    def _cache_insert_live(self, reqs: List[Request]) -> None:
        """Index each request's written full pages into the prefix cache
        (progressive insert: a request sharing a prompt head hits on pages
        written earlier in the same wave, not only after release).
        Callers set ``req.prefill_pos`` to the written token count first;
        ``insert`` skips partial pages."""
        if self.prefix_cache is None:
            return
        for r in reqs:
            row = self.mgr.tables.get(r.rid)
            if row:
                self.prefix_cache.insert(r.prompt + r.output, row,
                                         r.prefill_pos)

    def _prefill_chunk_step(self) -> None:
        """Advance the PREFILLING requests by one ``prefill_chunk`` budget.

        The budget is global across the prefill sub-batch: the rows split
        one chunk, oldest slot first, so a step's prefill work never
        scales with the number of prefills.  Each installment is reserved
        chunk-wise (`Scheduler.grow_prefill`); a request whose installment
        cannot get pages stalls this step and resumes from its cached
        pages later.  The sub-batch has the fixed shape (max_slots,
        prefill_chunk): padding rows are dead (tables -1, ``q_lens`` 0,
        ``q_start`` 1).  When a request's last chunk lands it turns
        RUNNING and samples its first token.
        """
        budget = self.prefill_chunk
        sel: List[Tuple[int, Request, int, int]] = []
        for slot in sorted(self.scheduler.running):
            if budget <= 0:
                break
            # re-fetch per slot: grow_prefill below may preempt a
            # PREFILLING victim in a slot this loop has not visited yet
            req = self.scheduler.running.get(slot)
            if req is None or req.status is not Status.PREFILLING:
                continue
            want = min(budget, req.total_len - req.prefill_pos)
            if not self.scheduler.grow_prefill(req, want):
                continue  # stalled: keeps its pages, resumes next step
            start = req.prefill_pos
            q_len = min(want, req.total_len - start)
            sel.append((slot, req, start, q_len))
            budget -= q_len
        # grow_prefill may have preempted rows selected earlier
        sel = [x for x in sel if self.scheduler.running.get(x[0]) is x[1]]
        if not sel:
            return
        B, C = self.max_slots, self.prefill_chunk
        batch = np.zeros((B, C), np.int64)
        q_lens = np.zeros((B,), np.int32)
        starts = np.ones((B,), np.int32)  # dead rows pose as resumes
        for i, (_, req, st0, ql) in enumerate(sel):
            batch[i, :ql] = (req.prompt + req.output)[st0:st0 + ql]
            starts[i] = st0
            q_lens[i] = ql
        logits = self._run_chunk([s for s, _, _, _ in sel], batch, starts,
                                 q_lens)

        done_rows, done_reqs = [], []
        for i, (_, req, st0, ql) in enumerate(sel):
            req.prefill_pos = st0 + ql
            if req.prefill_pos >= req.total_len:  # last chunk landed
                req.status = Status.RUNNING
                done_rows.append(i)
                done_reqs.append(req)
        self._cache_insert_live([r for _, r, _, _ in sel])
        if done_reqs:
            rows = torch.as_tensor(done_rows, device=self.device)
            self._sample_and_append(done_reqs, logits[rows],
                                    first=True)

    def _decode(self) -> None:
        st = dict(self.state)
        st["tables"] = self._tables_array(decode=True)
        tokens = np.zeros((self.max_slots,), np.int64)
        live = np.zeros((self.max_slots,), bool)
        reqs: List[Optional[Request]] = [None] * self.max_slots
        for slot, req in self.scheduler.running.items():
            if req.status is not Status.RUNNING:
                continue
            tokens[slot] = (req.prompt + req.output)[-1]
            live[slot] = True
            reqs[slot] = req
        logits, new_st = self.model.decode_step(
            self.params, torch.from_numpy(tokens).to(self.device), st,
            impl=self.impl, pages_per_block=self.pages_per_block,
            num_splits=self.num_splits)
        # dead slots keep their old pos (decode bumps everyone's)
        mask = torch.from_numpy(live).to(self.device)
        self.state["pos"] = torch.where(mask, new_st["pos"], st["pos"])
        rows = np.where(live)[0]
        self._sample_and_append([reqs[i] for i in rows],
                                logits[torch.from_numpy(rows).to(
                                    self.device)], first=False)

    def _sample_and_append(self, reqs: List[Request], logits: torch.Tensor,
                           first: bool) -> None:
        if reqs:
            # NaN guard, per-row isolation: a poisoned row fails *its*
            # request; survivors sample as if the bad row never existed
            finite = torch.isfinite(logits).all(dim=-1).cpu().numpy()
            if not finite.all():
                for r, ok in zip(reqs, finite):
                    if not ok:
                        self.scheduler.fail(r, NumericsError(
                            "non-finite logits in this request's row "
                            f"(step {self.steps})", rid=r.rid,
                            step=self.steps))
                keep = np.where(finite)[0]
                reqs = [reqs[i] for i in keep]
                logits = logits[torch.from_numpy(keep).to(logits.device)]
        if not reqs:
            return
        dev = logits.device
        sp = SampleParams(
            temperature=torch.tensor([r.temperature for r in reqs],
                                     dtype=torch.float32, device=dev),
            top_k=torch.tensor([r.top_k for r in reqs], device=dev),
            top_p=torch.tensor([r.top_p for r in reqs],
                               dtype=torch.float32, device=dev))
        toks = sample(self.gen, logits, sp).cpu().tolist()
        now = time.perf_counter()
        for r, t in zip(reqs, toks):
            r.output.append(int(t))
            if first and "ttft_s" not in r.metrics:
                r.metrics["ttft_s"] = now - r.metrics["t_arrive"]

    def _finish_done(self) -> List[Request]:
        done = []
        for req in list(self.scheduler.running.values()):
            if req.status is not Status.RUNNING:
                continue
            hit_eos = (req.eos_id is not None and req.output
                       and req.output[-1] == req.eos_id)
            if len(req.output) >= req.max_new_tokens or hit_eos:
                req.metrics["t_done"] = time.perf_counter()
                req.metrics["tok_s"] = len(req.output) / max(
                    req.metrics["t_done"] - req.metrics["t_arrive"], 1e-9)
                self.scheduler.finish(req)
                done.append(req)
        return done

    # ------------------------------------------------------------------
    def memory_report(self) -> Dict[str, float]:
        """KV memory accounting at the pool dtype's itemsize (the paper's
        <5% overhead metric)."""
        cfg = self.cfg
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        n_attn = self.model.n_attn_layers
        item = self.state["k_pages"].element_size()
        cache_bytes = (2 * n_attn * self.num_pages * cfg.page_size
                       * Hkv * hd * item)
        reserved = self.mgr.bytes_reserved(Hkv, hd, n_attn, item)
        live_tokens = sum(r.total_len
                          for r in self.scheduler.running.values())
        minimum = live_tokens * 2 * n_attn * Hkv * hd * item
        pc = self.prefix_cache
        return {
            "pool_bytes": float(cache_bytes),
            "reserved_bytes": float(reserved),
            "theoretical_min_bytes": float(minimum),
            "overhead_frac": (reserved / minimum - 1.0) if minimum else 0.0,
            "used_pages": float(self.mgr.used_pages),
            # prefix-cache residency: `cached_pages` are indexed in the
            # radix trie; the `reclaimable` subset is evictable on demand
            "cached_pages": float(pc.resident_pages) if pc else 0.0,
            "reclaimable_pages": float(pc.reclaimable()) if pc else 0.0,
            "prefix_hit_tokens": float(pc.hit_tokens) if pc else 0.0,
        }
