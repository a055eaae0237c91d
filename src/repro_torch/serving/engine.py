"""Serving engine: continuous batching over the paged KV cache (port of
``repro.serving.engine``: paged prefill, monolithic or chunked, the
global prefix cache, decode, fork with copy-on-write, the fault surface,
and the contiguous baseline).

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
pages are overwritten in place).  Recurrent (``R``, ``M``, ``S``) layers
refuse ``prefill_chunk`` and ``prefix_cache``, as in the JAX engine; their
state
lives per slot (``state["rec"]``), is written for the admitted slots
after each monolithic prefill and stepped by every decode.

Cross-attention reads a per-request context, which the model names: its
key ``model.extra_key`` and shape ``model.extra_shape`` — a VLM's
``image_embeds`` (n_image_tokens, d_vision), an encoder-decoder's
``frames`` (n_audio_frames, d_model).  ``add_request(req, extra)``
refuses a cross model's request without it (``InvalidRequest``) before
it holds anything.  The projected K/V live per slot
(``state["cross_k"]``/``["cross_v"]``, (model.n_cross_layers, max_slots,
model.cross_len, Hkv, D)), written for the admitted slots after a
monolithic prefill and after each chunk that holds a request's first
chunk, and copied to a fork's child.  Cross models refuse the prefix
cache, as the JAX engine does: their self-attention K/V depend on the
image or audio, not on the tokens alone.  MoE FFNs route only the live
tokens: the engine passes each step's live-token count from the host.

Sliding-window (``W``) layers keep their K/V in a ring of ``ceil(window
/ P) + 1`` pages, the first columns of each table row.  When every
attention layer is ``W`` (no ``A`` layer), the device tables are only
ring-wide, and a host row longer than the ring is truncated by design;
as in the JAX engine, the host page manager still reserves a page for
every token of a request, so a pool must hold the requests' full lengths
all the same.

``paged=False`` serves the paper's baseline instead: one max-length
buffer per slot (``state["k_buf"]``/``state["v_buf"]``), written by
position.  Prefill attention is K4 as in the paged engine, decode
attention the plain contiguous path, and every layer (``A``, ``W``,
``R``, ``M``, ``S``, ``C``, an encoder-decoder's) runs through the
model's one loop.  The host page manager
still admits by pages, as in the JAX engine.  The baseline refuses
``prefill_chunk``, ``prefix_cache`` and ``kv_dtype="int8"``
(``EngineConfigError``): the JAX baseline mixes int8 and unquantised K/V.

``fork_request`` shares a RUNNING request's full pages with a child
(refcount++) and copies its partial tail page (``core.cache.copy_page``);
it refuses windowed models (``InvalidRequest``), whose ring pages both
rows would overwrite in place.

The fault surface is the JAX engine's: a ``FaultPlan`` (``faults``)
wraps the host page manager (``FaultyPageManager``), the prefix cache's
attach, the prefill/decode dispatch (transient errors, retried up to
``max_step_retries`` times) and each sampled row (NaN logits, caught by
the NaN guard, always on); ``max_waiting`` and ``admit_watermark``
shed requests at ``add_request`` with ``Backpressure``.  ``stats`` and
``robustness_report`` count what happened.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cache import copy_page, init_contiguous
from repro_torch.core.paging import HostPageManager
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.device import resolve_device
from repro_torch.errors import (EngineConfigError, EngineError,
                                InternalError, InvalidRequest, NumericsError,
                                PoolExhausted, RequestTooLong,
                                SchedulerInvariantError, TransientDeviceError)
from repro_torch.kernels import check_impl
from repro_torch.models.api import build_model
from repro_torch.models.attention import kv_pool_dtype
from repro_torch.serving.faults import FaultPlan, FaultyPageManager
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
        faults: Optional[FaultPlan] = None,  # deterministic fault injection
        max_waiting: Optional[int] = None,  # bounded wait queue
        admit_watermark: Optional[float] = None,  # shed above this pool
        # utilization (a fraction in (0, 1]); None = off
        max_step_retries: int = 3,  # transient retries per dispatch
    ):
        self.paged = cfg.paged_attention if paged is None else paged
        recurrent = any(c in "RMS" for c in cfg.pattern())
        if prefill_chunk is not None:
            if prefill_chunk < 1:
                raise EngineConfigError(
                    "prefill_chunk must be >= 1 (or None)",
                    prefill_chunk=prefill_chunk)
            if not self.paged:
                raise EngineConfigError(
                    "chunked prefill requires the paged engine (paged=True)",
                    prefill_chunk=prefill_chunk)
            if recurrent:
                raise EngineConfigError(
                    "chunked prefill does not support recurrent layers "
                    f"(pattern {cfg.layer_pattern!r}): their prefill state "
                    "replay assumes the whole prompt",
                    pattern=cfg.layer_pattern)
        if not self.paged and cfg.kv_dtype == "int8":
            raise EngineConfigError(
                "the contiguous baseline (paged=False) keeps unquantised "
                "K/V: kv_dtype='int8' needs the paged engine",
                kv_dtype=cfg.kv_dtype)
        if prefix_cache and not self.paged:
            raise EngineConfigError(
                "prefix_cache requires the paged engine (paged=True)")
        check_impl(impl)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = build_model(cfg)
        if prefix_cache and self.model.window > 0:
            raise EngineConfigError(
                "prefix_cache requires window=0: windowed layers overwrite "
                "their ring pages in place, so cached pages shared from a "
                "live donor would be mutated", window=self.model.window)
        if prefix_cache and self.model.n_cross_layers:
            raise EngineConfigError(
                "prefix_cache does not support encoder/cross-attention "
                "models: self-attention K/V depend on the per-request "
                "image/audio context, so token-keyed page sharing would "
                "be wrong", family=cfg.family)
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
        self.faults = faults
        self.max_step_retries = max_step_retries
        self.mgr = (FaultyPageManager(num_pages, ps, faults)
                    if faults is not None else HostPageManager(num_pages, ps))
        self.prefix_cache = (PrefixCache(self.mgr, faults=faults)
                             if prefix_cache else None)
        self.scheduler = Scheduler(self.mgr, max_slots, max_seq_len,
                                   prefill_chunk=prefill_chunk,
                                   max_waiting=max_waiting,
                                   admit_watermark=admit_watermark,
                                   prefix_cache=self.prefix_cache)
        self.state = self._init_state()
        self.steps = 0
        self.stats: Dict[str, int] = {"transient_retries": 0}

    # ------------------------------------------------------------------
    def _init_state(self) -> Dict:
        cfg = self.cfg
        n_attn, Hkv = self.model.n_attn_layers, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        st = {"pos": torch.zeros((self.max_slots,), dtype=torch.int32,
                                 device=self.device)}
        if self.paged:
            pool = (n_attn, self.num_pages, cfg.page_size, Hkv, hd)
            pool_dt = kv_pool_dtype(cfg, self.dtype)
            st["k_pages"] = torch.zeros(pool, dtype=pool_dt,
                                        device=self.device)
            st["v_pages"] = torch.zeros(pool, dtype=pool_dt,
                                        device=self.device)
        else:
            # the paper's baseline: contiguous max-length per-slot buffers
            buf = init_contiguous(n_attn, self.max_slots, self.max_seq_len,
                                  Hkv, hd, self.dtype, device=self.device)
            st["k_buf"], st["v_buf"] = buf.k, buf.v
        rec = self.model.init_rec_state(self.max_slots, self.dtype,
                                        self.device)
        if rec is not None:  # recurrent state slots
            st["rec"] = rec
        if self.model.n_cross_layers:  # per-slot image or audio K/V
            ck = (self.model.n_cross_layers, self.max_slots,
                  self.model.cross_len, Hkv, hd)
            st["cross_k"] = torch.zeros(ck, dtype=self.dtype,
                                        device=self.device)
            st["cross_v"] = torch.zeros(ck, dtype=self.dtype,
                                        device=self.device)
        return st

    # ------------------------------------------------------------------
    def add_request(self, req: Request, extra: Optional[Dict] = None
                    ) -> int:
        """Validate and enqueue ``req``, with its per-request context
        ``extra`` (a model with cross-attention layers needs
        ``extra[model.extra_key]`` of shape ``model.extra_shape``: image
        embeddings or audio frames; other models ignore it).

        Raises structured errors before the request holds any resources:
        ``InvalidRequest`` (bad sampling params, a cross model's missing
        or mis-shaped context), ``RequestTooLong`` (prompt +
        budget exceeds max_seq_len), or ``Backpressure`` (wait queue
        full, or the pool above the admission watermark; it carries a
        retry hint).
        """
        validate_sample_params(req)
        key = self.model.extra_key
        if key is not None:
            want = tuple(self.model.extra_shape)
            got = tuple(getattr((extra or {}).get(key), "shape", ()))
            if got != want:
                raise InvalidRequest(
                    f"a cross-attention model needs extra[{key!r}] of "
                    f"shape {want}, got {got or None}", rid=req.rid)
        if req.prompt_len + req.max_new_tokens > self.max_seq_len:
            raise RequestTooLong(
                f"request exceeds engine max_seq_len: prompt_len "
                f"{req.prompt_len} + max_new_tokens {req.max_new_tokens} > "
                f"{self.max_seq_len}", rid=req.rid,
                limit=self.max_seq_len)
        req.metrics["t_arrive"] = time.perf_counter()
        req.metrics["step_arrive"] = self.steps
        if extra is not None:
            req.metrics["_extra"] = extra  # modality embeddings
        self.scheduler.add(req)  # may raise Backpressure (nothing held)
        return req.rid

    def generate(self, reqs: List[Request],
                 extras: Optional[List[Optional[Dict]]] = None,
                 max_steps: int = 100_000) -> List[Request]:
        """Blocking helper: run until the given requests all finish."""
        for r, e in zip(reqs, extras or [None] * len(reqs)):
            self.add_request(r, e)
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
                self._dispatch("prefill", self._prefill, admitted)
                # prefill's sampled token may already hit EOS / max_new
                finished += self._finish_done()
        elif any(r.status is Status.PREFILLING
                 for r in self.scheduler.running.values()):
            # each PREFILLING row caches its share of one chunk budget;
            # rows whose last chunk lands sample their first token
            self._dispatch("prefill", self._prefill_chunk_step)
            finished += self._finish_done()
        if self._any_running():
            if self.paged:  # the baseline's buffers need no pages
                self.scheduler.extend_for_decode()
            # extend may have failed the last decoder (starvation)
            if self._any_running():
                self._dispatch("decode", self._decode)
                finished += self._finish_done()
        finished += self._drain_failed()
        return finished

    def _dispatch(self, site: str, fn, *args):
        """Run a prefill or decode dispatch with transient-fault retries.

        The plan's transient site fires before ``fn`` mutates any state,
        so a retry re-runs the dispatch from scratch, at once; after
        ``max_step_retries`` retries the structured error escapes.
        """
        for attempt in range(self.max_step_retries + 1):
            try:
                if (self.faults is not None
                        and self.faults.fire(site) == "transient"):
                    raise TransientDeviceError(
                        f"injected transient device error at {site} "
                        "dispatch", site=site, attempt=attempt)
                return fn(*args)
            except TransientDeviceError:
                self.stats["transient_retries"] += 1
                if attempt >= self.max_step_retries:
                    raise

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

    def robustness_report(self) -> Dict[str, int]:
        """Counters of the failure surface (beside ``memory_report``)."""
        s = self.scheduler
        pc = self.prefix_cache
        return {
            "failed": s.failed,
            "cancelled": s.cancelled,
            "shed": s.shed,
            "deadline_misses": s.deadline_misses,
            "preempted": s.preempted,
            "prefill_stalls": s.prefill_stalls,
            "transient_retries": self.stats["transient_retries"],
            "fault_fires": self.faults.fires if self.faults else 0,
            # prefix-cache hit surface (all 0 when the cache is off)
            "prefix_hits": pc.hits if pc else 0,
            "prefix_misses": pc.misses if pc else 0,
            "prefix_hit_tokens": pc.hit_tokens if pc else 0,
            "prefix_evicted_pages": pc.evicted_pages if pc else 0,
        }

    # ------------------------------------------------------------------
    # prefix sharing (paper §III contribution 1: fork + copy-on-write)
    def fork_request(self, src: Request, max_new_tokens: int = 64,
                     **sampling) -> Request:
        """Fork a RUNNING request: the child aliases the parent's full KV
        pages (refcount++, no copy) and gets a copy of the partial tail
        page.  The child enters the batch at once (no re-prefill of the
        shared prefix) and decodes from the parent's position.

        Refused (``InvalidRequest``) unless ``src`` is RUNNING on the
        paged engine, and on windowed models: a 'W' layer writes at
        column ``(pos // P) % ring`` of its row, which is one of the
        shared pages, so parent and child would overwrite each other's
        K/V.  ``RequestTooLong`` when the child would outgrow
        ``max_seq_len``; ``PoolExhausted`` without a free slot or a page
        for the tail.
        """
        if src.status is not Status.RUNNING or not self.paged:
            raise InvalidRequest("fork requires a RUNNING request on the "
                                 "paged engine", rid=src.rid)
        if self.model.window > 0:
            raise InvalidRequest(
                "fork requires window=0: windowed layers overwrite their "
                "ring pages in place, so shared pages would be written by "
                "both rows", rid=src.rid, window=self.model.window)
        if src.total_len + max_new_tokens > self.max_seq_len:
            raise RequestTooLong("fork child exceeds engine max_seq_len",
                                 rid=src.rid, limit=self.max_seq_len)
        slots = self.scheduler.free_slots()
        if not slots:
            raise PoolExhausted("no free slot for fork", rid=src.rid,
                                resource="slots")
        ps = self.cfg.page_size
        # page math follows the cached length (== the parent's decode
        # position): the last sampled token is the next decode input, not
        # yet in the pools
        cached_len = self.mgr.lens[src.rid]
        full_pages = cached_len // ps
        need_tail = 1 if cached_len % ps else 0
        if need_tail + self.scheduler.headroom > self.mgr.available_pages:
            raise PoolExhausted("no pages for fork tail", rid=src.rid,
                                resource="pages")
        seq = src.prompt + src.output
        child = Request(prompt=list(seq), max_new_tokens=max_new_tokens,
                        parent=src.rid, **sampling)
        child.metrics["t_arrive"] = time.perf_counter()
        # all-or-nothing: on a dry pool the manager rolls its refcount
        # bumps back and returns False, leaving no child row behind
        if not self.mgr.fork(src.rid, child.rid):
            raise PoolExhausted("no pages for fork tail", rid=src.rid,
                                resource="pages")
        st = self.state
        if need_tail:  # copy-on-write: the child's own tail page
            copy_page(st["k_pages"], st["v_pages"],
                      self.mgr.tables[src.rid][full_pages],
                      self.mgr.tables[child.rid][full_pages])
        slot = slots[0]
        child.status = Status.RUNNING
        child.slot = slot
        self.scheduler.running[slot] = child
        st["pos"][slot] = st["pos"][src.slot]
        if "_extra" in src.metrics:  # a re-prefill after preemption
            child.metrics["_extra"] = src.metrics["_extra"]
        for key in ("cross_k", "cross_v"):  # the parent's cross K/V
            if key in st:
                st[key][:, slot] = st[key][:, src.slot]
        if "rec" in st:  # the parent's recurrent state
            for tree in st["rec"].values():
                for v in tree.values():
                    v[:, slot] = v[:, src.slot]
        child.metrics["ttft_s"] = 0.0  # prefix shared: no prefill
        return child

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
        if self.paged:
            sub_state = {"pos": lens_t, "k_pages": st["k_pages"],
                         "v_pages": st["v_pages"],
                         "tables": self._tables_array()[idx, 0]}
        else:  # the baseline: each prompt into its slot's buffer row
            sub_state = {"pos": lens_t, "k_buf": st["k_buf"],
                         "v_buf": st["v_buf"], "slots": idx}
        logits, new_st = self.model.prefill(
            self.params, torch.from_numpy(batch).to(self.device), sub_state,
            lens=lens_t, extra=self._collect_extra(reqs), impl=self.impl,
            n_live=int(lens.sum()))
        st["pos"][idx] = lens_t  # the caches were written in place
        if "rec" in new_st:  # the admitted slots' recurrent state
            for code, tree in new_st["rec"].items():
                for k, v in tree.items():
                    st["rec"][code][k][:, idx] = v
        for key in ("cross_k", "cross_v"):  # their cross K/V
            if key in new_st:
                st[key][:, idx] = new_st[key]
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
        logits = self._run_chunk(slots, reqs, batch, starts, q_lens)
        for i, r in enumerate(reqs):
            r.prefill_pos = int(lens[i])
        self._cache_insert_live(reqs)
        self._sample_and_append(reqs, logits, first=True)

    def _run_chunk(self, slots: List[int], reqs: List[Request],
                   batch: np.ndarray, starts: np.ndarray,
                   q_lens: np.ndarray) -> torch.Tensor:
        """One ``prefill_chunk`` call over the rows of ``batch`` (rows past
        ``slots`` are dead padding, posing as resumes); the live slots'
        positions advance to ``starts + q_lens``, and their cross K/V are
        written back.  Returns each row's last-live-token logits."""
        n, B = len(slots), batch.shape[0]
        tables = np.full((B, self.pages_per_seq), -1, np.int32)
        tables[:n] = self._tables_np()[np.asarray(slots), 0]
        st = self.state
        sub_state = {"k_pages": st["k_pages"], "v_pages": st["v_pages"],
                     "tables": torch.from_numpy(tables).to(self.device)}
        idx = torch.as_tensor(slots, device=self.device)
        for key in ("cross_k", "cross_v"):  # the rows' cached cross K/V
            if key in st:
                sub = st[key].new_zeros((st[key].shape[0], B)
                                        + st[key].shape[2:])
                sub[:, :n] = st[key][:, idx]
                sub_state[key] = sub
        q_start = torch.from_numpy(starts).to(self.device)
        q_len_t = torch.from_numpy(q_lens).to(self.device)
        logits, new_st = self.model.prefill_chunk(
            self.params, torch.from_numpy(batch).to(self.device), sub_state,
            q_start=q_start, q_lens=q_len_t,
            extra=self._collect_extra(reqs, pad_to=B), impl=self.impl,
            pages_per_block=self.pages_per_block,
            num_splits=self.num_splits, n_live=int(q_lens.sum()))
        st["pos"][idx] = (q_start + q_len_t)[:n]  # pools written in place
        for key in ("cross_k", "cross_v"):
            if key in new_st:
                st[key][:, idx] = new_st[key][:, :n]
        return logits

    def _collect_extra(self, reqs: List[Request],
                       pad_to: Optional[int] = None) -> Optional[Dict]:
        """The batch's per-request context ``{model.extra_key}`` of shape
        (B, *model.extra_shape) on the device, zeros for rows without it
        (padding rows), or None for a model without cross-attention."""
        key = self.model.extra_key
        if key is None:
            return None
        ctx = torch.zeros((pad_to or len(reqs), *self.model.extra_shape),
                          dtype=self.dtype, device=self.device)
        for i, r in enumerate(reqs):
            if "_extra" in r.metrics:
                ctx[i] = torch.as_tensor(r.metrics["_extra"][key])
        return {key: ctx}

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
        logits = self._run_chunk([s for s, _, _, _ in sel],
                                 [r for _, r, _, _ in sel], batch, starts,
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
        if self.paged:
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
        mask = torch.from_numpy(live).to(self.device)
        logits, new_st = self.model.decode_step(
            self.params, torch.from_numpy(tokens).to(self.device), st,
            impl=self.impl, pages_per_block=self.pages_per_block,
            num_splits=self.num_splits, live=mask, n_live=int(live.sum()))
        # dead slots keep their old pos (decode bumps everyone's)
        self.state["pos"] = torch.where(mask, new_st["pos"], st["pos"])
        rows = np.where(live)[0]
        self._sample_and_append([reqs[i] for i in rows],
                                logits[torch.from_numpy(rows).to(
                                    self.device)], first=False)

    def _sample_and_append(self, reqs: List[Request], logits: torch.Tensor,
                           first: bool) -> None:
        if self.faults is not None and reqs:
            # injected NaN logits: per-row poison, caught by the guard
            bad = [i for i, r in enumerate(reqs)
                   if self.faults.fire("sample", rid=r.rid) == "nan"]
            if bad:
                logits = logits.clone()
                logits[torch.as_tensor(bad, device=logits.device)] = float(
                    "nan")
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
        """KV memory accounting at the cache dtype's itemsize (the paper's
        <5% overhead metric).  The baseline reserves its whole buffers, and
        reports ``used_pages`` -1."""
        cfg = self.cfg
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        n_attn = self.model.n_attn_layers
        if self.paged:
            item = self.state["k_pages"].element_size()
            cache_bytes = (2 * n_attn * self.num_pages * cfg.page_size
                           * Hkv * hd * item)
            reserved = self.mgr.bytes_reserved(Hkv, hd, n_attn, item)
        else:
            item = self.state["k_buf"].element_size()
            cache_bytes = (2 * n_attn * self.max_slots * self.max_seq_len
                           * Hkv * hd * item)
            reserved = cache_bytes
        live_tokens = sum(r.total_len
                          for r in self.scheduler.running.values())
        minimum = live_tokens * 2 * n_attn * Hkv * hd * item
        pc = self.prefix_cache
        return {
            "pool_bytes": float(cache_bytes),
            "reserved_bytes": float(reserved),
            "theoretical_min_bytes": float(minimum),
            "overhead_frac": (reserved / minimum - 1.0) if minimum else 0.0,
            "used_pages": float(self.mgr.used_pages) if self.paged else -1.0,
            # prefix-cache residency: `cached_pages` are indexed in the
            # radix trie; the `reclaimable` subset is evictable on demand
            "cached_pages": float(pc.resident_pages) if pc else 0.0,
            "reclaimable_pages": float(pc.reclaimable()) if pc else 0.0,
            "prefix_hit_tokens": float(pc.hit_tokens) if pc else 0.0,
        }
