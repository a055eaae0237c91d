"""PyTorch port: the fault surface (``serving.faults``, the engine's
dispatch retries, NaN guard, backpressure, deadlines and cancellation),
ported from ``tests/test_faults.py`` onto the port's engine, scheduler
and page manager, with the same pinned seeds (``SOAK_SEED`` 0xFA57).

Every case of the JAX suite runs here on the port: the error taxonomy,
the allocator's double-free guards, sampling-parameter and length
refusals, the bounded queue and the pool watermark (``Backpressure``),
deadlines, cancellation in every lifecycle state, the fault plan's
validation and replay, per-request fault isolation (NaN rows, injected
allocation failures, transient dispatch errors, retried to the same
output), the wrap of unstructured failures, both chaos soaks (allocator
invariants after every step), and the prefix cache's fault sites.  The
tests at the end hold the port against the JAX engine on the same
weights and plan: the plan's fire sequence, the survivors' tokens of the
NaN injection, the transient retry's tokens, and the
``robustness_report`` keys.  Engines here take ``rng`` as the seed of
the port's sampler (every request is greedy).
"""

import random

import jax
import numpy as np
import pytest

from repro.configs import get_smoke
from repro.errors import Backpressure as JBackpressure
from repro.serving import Engine as JEngine, Request as JRequest
from repro.serving.faults import FaultPlan as JFaultPlan
from repro.serving.faults import FaultRule as JFaultRule
from repro_torch.configs import get_smoke as tget_smoke
from repro_torch.core.paging import HostPageManager
from repro_torch.errors import (Backpressure, DeadlineExceeded, EngineError,
                                InternalError, InvalidRequest, NumericsError,
                                PoolExhausted, RequestTooLong,
                                SchedulerInvariantError, TransientDeviceError)
from repro_torch.models import params_from_numpy
from repro_torch.serving import Engine as PortEngine, Request, Status
from repro_torch.serving.faults import FaultPlan, FaultRule, FaultyPageManager
from repro_torch.serving.scheduler import LIVE, Scheduler

import _torch_helpers  # noqa: F401  (one torch thread per test worker)
from test_scheduler_preempt import check_allocator_invariants

SOAK_SEED = 0xFA57  # pinned, as in tests/test_faults.py


@pytest.fixture(scope="module")
def donor():
    """Shared weights: the JAX smoke engine's, converted."""
    eng = JEngine(get_smoke("llama2-7b"), max_slots=1, max_seq_len=16)
    return tget_smoke("llama2-7b"), params_from_numpy(
        jax.tree_util.tree_map(np.asarray, eng.params), device="cpu")


def Engine(cfg, params=None, *, rng=0, **kw):
    """The port's engine on the CPU; ``rng`` seeds its sampler."""
    return PortEngine(cfg, params, device="cpu", seed=rng, **kw)


# ---------------------------------------------------------------------------
# taxonomy + allocator hardening
# ---------------------------------------------------------------------------
def test_taxonomy_refines_builtin_exceptions():
    """The structured hierarchy must not break legacy `except` clauses."""
    assert issubclass(InvalidRequest, ValueError)
    assert issubclass(RequestTooLong, InvalidRequest)
    assert issubclass(PoolExhausted, RuntimeError)
    assert issubclass(SchedulerInvariantError, RuntimeError)
    assert issubclass(InternalError, RuntimeError)
    for cls in (InvalidRequest, RequestTooLong, PoolExhausted,
                NumericsError, SchedulerInvariantError, DeadlineExceeded,
                TransientDeviceError, InternalError, Backpressure):
        assert issubclass(cls, EngineError)
    err = PoolExhausted("dry", rid=7, resource="pages")
    assert err.rid == 7 and err.context["resource"] == "pages"
    assert "rid=7" in str(err)


def test_free_unknown_rid_raises():
    """Freeing a rid with no table row must raise, not silently
    no-op (the old `tables.pop(rid, [])` hid scheduler double-frees)."""
    mgr = HostPageManager(num_pages=4, page_size=4)
    with pytest.raises(SchedulerInvariantError, match="unknown rid"):
        mgr.free(7)
    # a full free cycle, then a second free of the same rid: caught
    assert mgr.reserve(0, 6)
    mgr.free(0)
    with pytest.raises(SchedulerInvariantError):
        mgr.free(0)
    assert sorted(mgr.free_list) == list(range(4))  # no corruption


def test_double_free_of_page_detected():
    """A page freed while its refcount is already 0 is the
    free-list-corruption signature (the page would be handed out twice) —
    must raise instead of pushing the duplicate."""
    mgr = HostPageManager(num_pages=4, page_size=4)
    assert mgr.reserve(0, 6)
    stale_row = list(mgr.tables[0])
    mgr.free(0)
    # forge the stale row back (what a buggy scheduler would do): its
    # pages are on the free list at refcount 0, so freeing must trip
    mgr.tables[1] = stale_row
    mgr.lens[1] = 6
    with pytest.raises(SchedulerInvariantError, match="double free"):
        mgr.free(1)


@pytest.mark.parametrize("kw", [
    dict(temperature=-0.5),
    dict(temperature=float("nan")),
    dict(top_p=1.5),
    dict(top_p=-0.1),
    dict(top_p=float("nan")),
    dict(top_k=-1),
    dict(max_new_tokens=0),
])
def test_invalid_sample_params_rejected_at_add(donor, kw):
    """Malformed sampling knobs raise a structured
    InvalidRequest at add_request time instead of NaN-ing downstream."""
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=32)
    req = Request(prompt=[1, 2, 3], **kw)
    with pytest.raises(InvalidRequest):
        eng.add_request(req)
    assert not eng.scheduler.waiting, "rejected request must hold nothing"
    # still a ValueError for legacy callers
    with pytest.raises(ValueError):
        eng.add_request(Request(prompt=[1], **kw))


def test_request_too_long_is_structured(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=16)
    with pytest.raises(RequestTooLong, match="max_seq_len"):
        eng.add_request(Request(prompt=[1] * 12, max_new_tokens=8))


# ---------------------------------------------------------------------------
# backpressure + deadlines
# ---------------------------------------------------------------------------
def test_bounded_queue_sheds_with_retry_hint(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=1, max_seq_len=32,
                 max_waiting=2)
    eng.add_request(Request(prompt=[1] * 4, max_new_tokens=2))
    eng.add_request(Request(prompt=[2] * 4, max_new_tokens=2))
    with pytest.raises(Backpressure) as ei:
        eng.add_request(Request(prompt=[3] * 4, max_new_tokens=2))
    bp = ei.value
    assert bp.reason == "queue_full"
    assert bp.retry_after_steps >= 1
    assert bp.queue_depth == 2
    assert eng.scheduler.shed == 1
    assert eng.robustness_report()["shed"] == 1


def test_pool_watermark_sheds_instead_of_thrashing(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=4, max_seq_len=64,
                 pool_tokens=64, admit_watermark=0.5)
    eng.add_request(Request(prompt=[1] * 40, max_new_tokens=4))
    eng.step()  # admit + prefill: well past 50% of the 64-token pool
    util = eng.mgr.used_pages / eng.mgr.num_pages
    assert util >= 0.5
    with pytest.raises(Backpressure) as ei:
        eng.add_request(Request(prompt=[2] * 8, max_new_tokens=2))
    assert ei.value.reason == "pool_watermark"
    assert ei.value.pool_util == pytest.approx(util)
    assert ei.value.retry_after_steps >= 1
    # preemption pressure was never created: shedding happened at the door
    assert eng.scheduler.preempted == 0


def test_deadline_exceeded_fails_request_and_spares_batchmates(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64)
    slow = Request(prompt=[1] * 4, max_new_tokens=40, deadline_steps=5)
    ok = Request(prompt=[2] * 4, max_new_tokens=8)
    eng.add_request(slow)
    eng.add_request(ok)
    for _ in range(40):
        if slow.done and ok.done:
            break
        eng.step()
    assert slow.status is Status.FAILED
    assert isinstance(slow.error, DeadlineExceeded)
    assert len(slow.output) < 40
    assert slow.rid not in eng.mgr.tables, "expired request must free pages"
    assert ok.status is Status.FINISHED and len(ok.output) == 8
    assert eng.robustness_report()["deadline_misses"] == 1


def test_ttft_deadline_cuts_stuck_prefill(donor):
    """A request that cannot produce its first token inside the TTFT
    budget (long chunked prefill) is failed; the short one finishes."""
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=128,
                 prefill_chunk=4)
    long_req = Request(prompt=[1] * 60, max_new_tokens=4,
                       ttft_deadline_steps=4)  # needs 15 chunks: hopeless
    short = Request(prompt=[2] * 4, max_new_tokens=6)
    eng.add_request(long_req)
    eng.add_request(short)
    for _ in range(60):
        if long_req.done and short.done:
            break
        eng.step()
    assert long_req.status is Status.FAILED
    assert isinstance(long_req.error, DeadlineExceeded)
    assert long_req.output == []
    assert long_req.rid not in eng.mgr.tables
    assert short.status is Status.FINISHED
    check_allocator_invariants(eng.mgr, eng.scheduler)


def test_step_returns_failed_requests(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64)
    req = Request(prompt=[1] * 4, max_new_tokens=40, deadline_steps=2)
    eng.add_request(req)
    terminal = []
    for _ in range(6):
        terminal += eng.step()
        if req.done:
            break
    assert req in terminal, "step() must report deadline failures"


# ---------------------------------------------------------------------------
# cancellation in every lifecycle state
# ---------------------------------------------------------------------------
def test_cancel_waiting_request(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=1, max_seq_len=32)
    first = Request(prompt=[1] * 4, max_new_tokens=6)
    queued = Request(prompt=[2] * 4, max_new_tokens=6)
    eng.add_request(first)
    eng.add_request(queued)
    eng.step()  # first admitted; queued still WAITING
    assert queued.status is Status.WAITING
    assert eng.cancel_request(queued.rid) is True
    assert queued.status is Status.CANCELLED and queued.done
    assert queued not in eng.scheduler.waiting
    assert queued.rid not in eng.mgr.tables
    # unknown/terminal rids: no-op, not an exception
    assert eng.cancel_request(queued.rid) is False
    assert eng.cancel_request(999_999) is False
    while not first.done:
        eng.step()
    assert first.status is Status.FINISHED
    assert eng.scheduler.cancelled == 1


def test_cancel_running_request_spares_batchmates(donor):
    """Cancelling mid-decode frees the slot+pages and leaves the
    co-batched requests' outputs bit-identical to an uncancelled run."""
    cfg, params = donor
    key = 9
    prompts = [[3 + i] * (4 + 2 * i) for i in range(3)]

    ref = Engine(cfg, params=params, max_slots=3, max_seq_len=64, rng=key)
    ref_reqs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
    ref.generate(ref_reqs)

    eng = Engine(cfg, params=params, max_slots=3, max_seq_len=64, rng=key)
    reqs = [Request(prompt=list(p), max_new_tokens=10) for p in prompts]
    for r in reqs:
        eng.add_request(r)
    eng.step()
    eng.step()
    victim = reqs[1]
    assert victim.status is Status.RUNNING
    assert eng.cancel_request(victim.rid)
    assert victim.status is Status.CANCELLED
    assert victim.rid not in eng.mgr.tables
    check_allocator_invariants(eng.mgr, eng.scheduler)
    for _ in range(100):
        if all(r.done for r in reqs):
            break
        eng.step()
    for i in (0, 2):
        assert reqs[i].status is Status.FINISHED
        assert reqs[i].output == ref_reqs[i].output, (
            "cancellation must not disturb co-batched outputs")
    assert eng.mgr.used_pages == 0


def test_cancel_prefilling_mid_chunk_no_ghost_row(donor):
    """Cancel between two prefill chunks: pages released immediately and
    the next decode sub-batch carries no ghost table row for the slot."""
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=128,
                 prefill_chunk=4)
    long_req = Request(prompt=[1] * 40, max_new_tokens=4)
    short = Request(prompt=[2] * 4, max_new_tokens=12)
    eng.add_request(long_req)
    eng.add_request(short)
    for _ in range(8):
        eng.step()
        if (long_req.status is Status.PREFILLING and long_req.prefill_pos
                and short.status is Status.RUNNING):
            break
    assert long_req.status is Status.PREFILLING
    assert 0 < long_req.prefill_pos < long_req.total_len, "mid-chunk"
    slot = long_req.slot
    assert eng.cancel_request(long_req.rid)
    assert long_req.status is Status.CANCELLED
    assert long_req.rid not in eng.mgr.tables
    assert slot not in eng.scheduler.running
    # the decode-facing table row for the freed slot must be blank
    tables = np.asarray(eng._tables_array(decode=True))
    assert (tables[slot] == -1).all(), "ghost table row after cancel"
    check_allocator_invariants(eng.mgr, eng.scheduler)
    while not short.done:
        eng.step()
    assert short.status is Status.FINISHED
    assert len(short.output) == 12


def test_cancel_preempted_request(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=4, max_seq_len=64,
                 pool_tokens=96)  # oversubscribed: preemption guaranteed
    reqs = [Request(prompt=[1] * 40, max_new_tokens=24) for _ in range(4)]
    for r in reqs:
        eng.add_request(r)
    victim = None
    for _ in range(200):
        eng.step()
        victim = next((r for r in reqs
                       if r.status is Status.PREEMPTED), None)
        if victim is not None:
            break
    assert victim is not None, "pressure never preempted anyone"
    assert victim in eng.scheduler.waiting
    assert eng.cancel_request(victim.rid)
    assert victim.status is Status.CANCELLED
    assert victim not in eng.scheduler.waiting
    check_allocator_invariants(eng.mgr, eng.scheduler)
    for _ in range(300):
        if all(r.done for r in reqs):
            break
        eng.step()
    assert all(r.done for r in reqs)
    assert eng.mgr.used_pages == 0


def test_cancel_stalled_on_dry_pool_unblocks_peer(donor):
    """A prefill stalled on a dry pool is cancellable; cancelling the
    *decoding* page-holder instead frees the pages the stalled prefill
    was waiting on, so it resumes without recompute."""
    cfg, params = donor
    ps = cfg.page_size
    # pool == one max-length sequence (8 pages): a short decoder plus a
    # 6-page prompt cannot coexist, so b's third chunk must stall while
    # a (RUNNING) keeps the preemption path off (stall, don't preempt)
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=8 * ps,
                 pool_tokens=8 * ps, prefill_chunk=2 * ps)
    a = Request(prompt=[1] * (2 * ps), max_new_tokens=2 * ps)
    b = Request(prompt=[2] * (6 * ps), max_new_tokens=2)
    eng.add_request(a)
    eng.add_request(b)
    for _ in range(12):
        eng.step()
        if eng.scheduler.prefill_stalls:
            break
    assert eng.scheduler.prefill_stalls, "pool never ran dry mid-prefill"
    assert b.status is Status.PREFILLING
    assert 0 < b.prefill_pos < b.total_len, "stalled mid-prompt"
    assert eng.cancel_request(a.rid)  # free the decoder's pages
    check_allocator_invariants(eng.mgr, eng.scheduler)
    for _ in range(40):
        if b.done:
            break
        eng.step()
    assert b.status is Status.FINISHED, \
        "cancel must unblock the stalled prefill"
    assert len(b.output) == 2
    assert eng.mgr.used_pages == 0


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------
def test_fault_plan_validates_and_replays():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultPlan([FaultRule(site="warp", kind="nan")])
    with pytest.raises(ValueError, match="invalid at site"):
        FaultPlan([FaultRule(site="reserve", kind="nan")])

    def drive(plan):
        out = []
        for i in range(50):
            out.append(plan.fire("extend", rid=i % 3))
            out.append(plan.fire("decode"))
        return out

    rules = lambda: [FaultRule(site="extend", kind="alloc_fail", prob=0.3,
                               times=None),
                     FaultRule(site="decode", kind="transient", prob=0.2,
                               times=None)]
    a = drive(FaultPlan(rules(), seed=123))
    b = drive(FaultPlan(rules(), seed=123))
    c = drive(FaultPlan(rules(), seed=124))
    assert a == b, "same seed + schedule must replay identically"
    assert a != c
    assert any(a), "plan never fired at these probabilities"


def test_fault_rule_nth_and_rid_targeting():
    plan = FaultPlan([FaultRule(site="extend", kind="alloc_fail",
                                rid=5, nth=2)])
    mgr = FaultyPageManager(num_pages=8, page_size=4, plan=plan)
    assert mgr.reserve(5, 4)
    assert mgr.reserve(6, 4)
    assert mgr.extend(6, 1)   # other rid: rule not consulted
    assert mgr.extend(5, 1)   # victim's 1st extend: passes
    assert not mgr.extend(5, 1)  # 2nd: injected dry pool
    assert mgr.extend(5, 1)   # rule exhausted (times=1): recovers
    assert plan.log == [("extend", 5, "alloc_fail", 3)]
    # injected failure mutated nothing: lens reflects the two successes
    assert mgr.lens[5] == 6


def test_injected_free_fault_is_structured(donor):
    cfg, params = donor
    plan = FaultPlan([FaultRule(site="free", kind="error", nth=1)])
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=32,
                 faults=plan)
    req = Request(prompt=[1] * 4, max_new_tokens=4)
    eng.add_request(req)
    eng.step()
    with pytest.raises(SchedulerInvariantError, match="injected"):
        eng.cancel_request(req.rid)


# ---------------------------------------------------------------------------
# fault isolation: the acceptance proof
# ---------------------------------------------------------------------------
def _mixed_batch_engines(cfg, params, plan, key):
    """Two engines, same params/rng/schedule; one with the fault plan.
    Batch shape: three deciders + one long prompt mid-prefill (mixed
    prefill+decode continuous batching)."""
    mk = lambda: ([Request(prompt=[3 + i] * (4 + 2 * i), max_new_tokens=10)
                   for i in range(3)]
                  + [Request(prompt=[9] * 36, max_new_tokens=4)])
    clean_reqs, fault_reqs = mk(), mk()
    clean = Engine(cfg, params=params, max_slots=4, max_seq_len=64,
                   prefill_chunk=4, rng=key)
    faulty = Engine(cfg, params=params, max_slots=4, max_seq_len=64,
                    prefill_chunk=4, rng=key, faults=plan)
    return clean, clean_reqs, faulty, fault_reqs


def test_nan_injection_isolated_and_survivors_bit_identical(donor):
    """Acceptance: NaN logits injected into one decoding request of a
    mixed prefill+decode batch → that request FAILED (NumericsError),
    pages back on the free list, survivors' token streams bit-identical
    to the uninjected run."""
    cfg, params = donor
    key = 21
    plan_rules = [FaultRule(site="sample", kind="nan", nth=3)]
    clean, clean_reqs, faulty, fault_reqs = _mixed_batch_engines(
        cfg, params, FaultPlan(plan_rules), key)
    victim = fault_reqs[1]
    plan_rules[0].rid = victim.rid  # rule list is owned by the plan

    clean.generate(clean_reqs, max_steps=300)
    assert all(r.status is Status.FINISHED for r in clean_reqs)

    faulty.generate(fault_reqs, max_steps=300)
    assert victim.status is Status.FAILED
    assert isinstance(victim.error, NumericsError)
    assert victim.error.rid == victim.rid
    assert len(victim.output) == 2, "failed on its 3rd sample"
    assert victim.rid not in faulty.mgr.tables, "pages must be released"
    for i in (0, 2, 3):
        assert fault_reqs[i].status is Status.FINISHED
        assert fault_reqs[i].output == clean_reqs[i].output, (
            f"survivor {i} diverged from the uninjected run")
    assert faulty.mgr.used_pages == 0
    assert sorted(faulty.mgr.free_list) == list(range(faulty.num_pages))
    assert all(c == 0 for c in faulty.mgr.refcount)
    assert faulty.robustness_report()["failed"] == 1
    assert faulty.faults.log[0][:3] == ("sample", victim.rid, "nan")


def test_alloc_failure_injection_recovers_transparently(donor):
    """Acceptance (allocation-failure half): a forced extend failure on
    one request triggers the normal dry-pool recovery (preempt + replay)
    and every request's output still matches the uninjected run."""
    cfg, params = donor
    key = 22
    plan_rules = [FaultRule(site="extend", kind="alloc_fail", nth=2)]
    clean, clean_reqs, faulty, fault_reqs = _mixed_batch_engines(
        cfg, params, FaultPlan(plan_rules), key)
    victim = fault_reqs[0]
    plan_rules[0].rid = victim.rid

    clean.generate(clean_reqs, max_steps=300)
    faulty.generate(fault_reqs, max_steps=300)
    assert faulty.faults.fires == 1, "injection never hit"
    # graceful degradation: the injected dry pool preempted someone (and
    # recompute made it transparent) — nobody failed
    assert faulty.scheduler.preempted >= 1
    assert faulty.robustness_report()["failed"] == 0
    for rc, rf in zip(clean_reqs, fault_reqs):
        assert rf.status is Status.FINISHED
        assert rf.output == rc.output
    assert faulty.mgr.used_pages == 0


def test_transient_device_error_retried_to_identical_output(donor):
    cfg, params = donor
    key = 23
    clean = Engine(cfg, params=params, max_slots=2, max_seq_len=48, rng=key)
    c = Request(prompt=[5] * 6, max_new_tokens=8)
    clean.generate([c])

    plan = FaultPlan([FaultRule(site="decode", kind="transient", nth=3)])
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=48, rng=key,
                 faults=plan)
    r = Request(prompt=[5] * 6, max_new_tokens=8)
    eng.generate([r])
    assert eng.stats["transient_retries"] == 1
    assert r.status is Status.FINISHED
    assert r.output == c.output, "retried step must be transparent"


def test_transient_retries_exhaust_to_structured_error(donor):
    cfg, params = donor
    plan = FaultPlan([FaultRule(site="decode", kind="transient", prob=1.0,
                                times=None)])
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=48,
                 faults=plan, max_step_retries=2)
    req = Request(prompt=[5] * 6, max_new_tokens=4)
    eng.add_request(req)
    # monolithic prefill + decode share a step: the prefill lands the
    # first token, then the decode dispatch exhausts its retries
    with pytest.raises(TransientDeviceError):
        eng.step()
    assert eng.stats["transient_retries"] == 3  # 1 try + 2 retries
    assert len(req.output) == 1, "prefill's token must survive the fault"
    # the engine survives: clearing the (dispatch-site) plan lets the
    # same request finish untouched
    eng.faults = None
    for _ in range(10):
        if req.done:
            break
        eng.step()
    assert req.status is Status.FINISHED


def test_unstructured_step_failure_wrapped_as_internal_error(donor):
    cfg, params = donor
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=32)
    eng.add_request(Request(prompt=[1] * 4, max_new_tokens=4))
    boom = ValueError("boom")

    def exploding(*a, **k):
        raise boom

    eng._decode = exploding
    with pytest.raises(InternalError) as ei:
        eng.step()  # prefill lands; the decode call then explodes
    assert ei.value.__cause__ is boom


# ---------------------------------------------------------------------------
# chaos soak (acceptance: >= 300 steps, invariants every step)
# ---------------------------------------------------------------------------
def _soak_plan():
    return FaultPlan(seed=SOAK_SEED, rules=[
        FaultRule(site="extend", kind="alloc_fail", prob=0.02, times=None),
        FaultRule(site="reserve", kind="alloc_fail", prob=0.01, times=None),
        FaultRule(site="sample", kind="nan", prob=0.004, times=None),
        FaultRule(site="decode", kind="transient", prob=0.01, times=None),
        FaultRule(site="prefill", kind="transient", prob=0.01, times=None),
    ])


def test_chaos_soak_engine(donor):
    """300+ steps of random admit/cancel under injected allocator, device
    and numerics faults: allocator invariants after every step, engine
    liveness after every step, only structured errors ever escape."""
    cfg, params = donor
    rnd = random.Random(SOAK_SEED)
    plan = _soak_plan()
    eng = Engine(cfg, params=params, max_slots=3, max_seq_len=64,
                 pool_tokens=120, prefill_chunk=8, faults=plan,
                 max_waiting=6, admit_watermark=0.95, max_step_retries=6)
    all_reqs, shed = [], 0
    # bounded prompt-length menu keeps eager-compile shapes finite
    lens = (5, 9, 14, 26)

    def submit():
        nonlocal shed
        r = Request(prompt=[1 + rnd.randrange(50)] * rnd.choice(lens),
                    max_new_tokens=rnd.randint(2, 8),
                    deadline_steps=(rnd.randint(15, 60)
                                    if rnd.random() < 0.3 else None))
        try:
            eng.add_request(r)
            all_reqs.append(r)
        except Backpressure:
            shed += 1

    for _ in range(2):
        submit()
    structured_escapes = 0
    for step in range(310):
        if rnd.random() < 0.5:
            submit()
        live = [r for r in all_reqs if not r.done]
        if live and rnd.random() < 0.06:
            eng.cancel_request(rnd.choice(live).rid)
        try:
            eng.step()
        except InternalError as e:
            pytest.fail(f"wrapped internal failure in step(): {e!r} "
                        f"(cause: {e.__cause__!r})")
        except EngineError:
            structured_escapes += 1  # allowed; engine must stay alive
        except Exception as e:  # noqa: BLE001
            pytest.fail(f"unstructured exception escaped step(): {e!r}")
        # allocator agreement, every step
        check_allocator_invariants(eng.mgr, eng.scheduler)
        # engine liveness: scheduler state coherent, reports computable
        assert all(r.status in LIVE
                   for r in eng.scheduler.running.values())
        assert all(r.status in (Status.WAITING, Status.PREEMPTED)
                   for r in eng.scheduler.waiting)
        eng.robustness_report()
        eng.memory_report()

    # drain: disable injection, let the tail finish
    eng.faults = None
    eng.mgr.plan = FaultPlan([])  # allocator sites off too
    for _ in range(600):
        if all(r.done for r in all_reqs):
            break
        eng.step()
        check_allocator_invariants(eng.mgr, eng.scheduler)
    assert all(r.done for r in all_reqs)
    # every page home, every refcount zero
    assert eng.mgr.used_pages == 0
    assert sorted(eng.mgr.free_list) == list(range(eng.num_pages))
    assert all(c == 0 for c in eng.mgr.refcount)
    # the soak must actually have exercised the failure surface
    # (read fires off the plan object: eng.faults was cleared for the
    # drain, so the report's fault_fires is 0 by then)
    rep = eng.robustness_report()
    assert plan.fires >= 5, "plan barely fired; raise the probs"
    assert rep["cancelled"] >= 3
    assert rep["failed"] >= 1
    assert shed == rep["shed"]
    statuses = {r.status for r in all_reqs}
    assert Status.FINISHED in statuses
    # terminal states partition the wave — nothing is left in limbo
    assert statuses <= {Status.FINISHED, Status.FAILED, Status.CANCELLED}


def test_chaos_soak_scheduler_level():
    """Model-free soak at 10x the step count: the scheduler + faulty
    allocator alone, driving admit/grow/extend/cancel/fail/finish."""
    rnd = random.Random(SOAK_SEED + 1)
    plan = FaultPlan(seed=SOAK_SEED + 1, rules=[
        FaultRule(site="extend", kind="alloc_fail", prob=0.05, times=None),
        FaultRule(site="reserve", kind="alloc_fail", prob=0.03, times=None),
    ])
    mgr = FaultyPageManager(num_pages=20, page_size=4, plan=plan)
    sched = Scheduler(mgr, max_slots=4, max_seq_len=256, headroom_pages=1,
                      prefill_chunk=8, max_waiting=5, admit_watermark=0.98)
    all_reqs = []

    def submit():
        r = Request(prompt=[1] * rnd.randint(6, 30),
                    max_new_tokens=rnd.randint(3, 12),
                    deadline_steps=(rnd.randint(20, 80)
                                    if rnd.random() < 0.4 else None))
        try:
            sched.add(r)
            r.metrics["step_arrive"] = step
            all_reqs.append(r)
        except Backpressure:
            pass

    step = 0
    for step in range(3000):
        if rnd.random() < 0.5:
            submit()
        sched.check_deadlines(step)
        sched.admit()
        check_allocator_invariants(mgr, sched)
        for r in sorted(sched.running.values(), key=lambda x: x.rid):
            if r.status is not Status.PREFILLING:
                continue
            if sched.running.get(r.slot) is not r:
                continue
            if sched.grow_prefill(r):
                if sched.running.get(r.slot) is not r:
                    continue
                r.prefill_pos = min(r.prefill_pos + 8, r.total_len)
                if r.prefill_pos >= r.total_len:
                    r.status = Status.RUNNING
        check_allocator_invariants(mgr, sched)
        if any(r.status is Status.RUNNING for r in sched.running.values()):
            sched.extend_for_decode()
            for r in sched.running.values():
                if r.status is Status.RUNNING:
                    r.output.append(0)
            check_allocator_invariants(mgr, sched)
        live = [r for r in all_reqs if not r.done
                and r.status is not Status.PREEMPTED]
        if live and rnd.random() < 0.05:
            sched.cancel(rnd.choice(live))
            check_allocator_invariants(mgr, sched)
        for r in list(sched.running.values()):
            if (r.status is Status.RUNNING
                    and len(r.output) >= r.max_new_tokens):
                sched.finish(r)
        check_allocator_invariants(mgr, sched)
        sched.failed_events.clear()

    assert sched.preempted >= 3
    assert sched.cancelled >= 5
    assert plan.fires >= 10
    # drain with injection off
    mgr.plan = FaultPlan([])
    for step in range(step, step + 2000):
        if not sched.has_work:
            break
        sched.check_deadlines(step)
        sched.admit()
        for r in sorted(sched.running.values(), key=lambda x: x.rid):
            if r.status is Status.PREFILLING \
                    and sched.running.get(r.slot) is r \
                    and sched.grow_prefill(r) \
                    and sched.running.get(r.slot) is r:
                r.prefill_pos = min(r.prefill_pos + 8, r.total_len)
                if r.prefill_pos >= r.total_len:
                    r.status = Status.RUNNING
        if any(r.status is Status.RUNNING for r in sched.running.values()):
            sched.extend_for_decode()
            for r in sched.running.values():
                if r.status is Status.RUNNING:
                    r.output.append(0)
        for r in list(sched.running.values()):
            if (r.status is Status.RUNNING
                    and len(r.output) >= r.max_new_tokens):
                sched.finish(r)
        check_allocator_invariants(mgr, sched)
    assert not sched.has_work
    assert len(mgr.free_list) == mgr.num_pages
    assert all(c == 0 for c in mgr.refcount)


# ---------------------------------------------------------------------------
# prefix-cache fault sites
# ---------------------------------------------------------------------------
def test_injected_attach_evict_degrades_to_cold_prefill(donor):
    """An `evict` injected at the `attach` site models the cached chain
    disappearing between lookup and attach: the admission must degrade to
    a plain cold prefill (same output), never a partial attach."""
    from test_prefix_cache import check_cache_invariants

    cfg, params = donor
    ps = cfg.page_size
    mk = lambda: Request(prompt=[5] * 3 * ps, max_new_tokens=4)

    # un-faulted cache-on reference: warm once, then the hit run
    ref_eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64,
                     prefix_cache=True, rng=3)
    ref_eng.generate([mk()], max_steps=200)
    ref = ref_eng.generate([mk()], max_steps=200)[0]
    assert ref.cached_prefix > 0, "reference run must actually hit"

    plan = FaultPlan([FaultRule(site="attach", kind="evict", nth=1)])
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64,
                 prefix_cache=True, faults=plan, rng=3)
    warm = eng.generate([mk()], max_steps=200)[0]  # cold: attach never
    assert plan.fires == 0                         # matches, rule unpolled
    hit = eng.generate([mk()], max_steps=200)[0]   # match -> injected evict
    assert plan.fires == 1
    assert eng.prefix_cache.attach_faults == 1
    assert hit.status is Status.FINISHED
    assert hit.cached_prefix == 0, "faulted attach must degrade to cold"
    assert hit.output == warm.output == ref.output
    check_cache_invariants(eng.mgr, eng.prefix_cache, eng.scheduler)

    # the plan is spent: the next identical prompt hits again (the cold
    # run re-seeded the evicted chain on release)
    again = eng.generate([mk()], max_steps=200)[0]
    assert again.cached_prefix > 0
    assert again.output == ref.output
    check_cache_invariants(eng.mgr, eng.prefix_cache, eng.scheduler)


def test_reserve_refusal_after_attach_rolls_back_and_retries(donor):
    """An injected reserve refusal *after* a successful attach exercises
    the admission rollback: the attached pages must return to cache-only
    residency (nothing leaked, nothing evicted) and the retry next step
    must hit again and produce the reference output."""
    from test_prefix_cache import check_cache_invariants

    cfg, params = donor
    ps = cfg.page_size
    mk = lambda: Request(prompt=[6] * 3 * ps, max_new_tokens=4)

    ref_eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64,
                     prefix_cache=True, rng=4)
    ref_eng.generate([mk()], max_steps=200)
    ref = ref_eng.generate([mk()], max_steps=200)[0]

    b = mk()
    plan = FaultPlan([FaultRule(site="reserve", kind="alloc_fail",
                                rid=b.rid, nth=1)])
    eng = Engine(cfg, params=params, max_slots=2, max_seq_len=64,
                 prefix_cache=True, faults=plan, rng=4)
    eng.generate([mk()], max_steps=200)
    resident_before = eng.prefix_cache.resident_pages
    assert resident_before >= 3

    eng.add_request(b)
    eng.step()  # admission: attach hits, injected reserve refusal
    assert plan.fires == 1
    assert b.status is Status.WAITING, "refused admission must re-queue"
    assert b.rid not in eng.mgr.tables, "rollback must free the attach"
    assert eng.prefix_cache.resident_pages == resident_before, (
        "rolled-back pages must stay cache-resident")
    check_cache_invariants(eng.mgr, eng.prefix_cache, eng.scheduler)

    for _ in range(200):
        if b.done:
            break
        eng.step()
    assert b.status is Status.FINISHED
    assert b.cached_prefix > 0, "retry must re-attach to the same chain"
    assert eng.prefix_cache.hits == 2  # rolled-back attach + the retry
    assert b.output == ref.output
    check_cache_invariants(eng.mgr, eng.prefix_cache, eng.scheduler)


# ---------------------------------------------------------------------------
# the port against the JAX engine, on the same weights and plans
# ---------------------------------------------------------------------------
def test_fault_plan_fires_as_the_reference_plan():
    """The same rules and seed fire at the same calls on either package."""
    def drive(plan):
        return [(plan.fire("extend", rid=i % 3), plan.fire("decode"),
                 plan.fire("sample", rid=i % 2)) for i in range(200)]

    def rules(R):
        return [R(site="extend", kind="alloc_fail", prob=0.2, times=None),
                R(site="decode", kind="transient", prob=0.1, times=4),
                R(site="sample", kind="nan", rid=1, nth=7)]

    a = FaultPlan(rules(FaultRule), seed=SOAK_SEED)
    b = JFaultPlan(rules(JFaultRule), seed=SOAK_SEED)
    assert drive(a) == drive(b)
    assert a.log == b.log and a.calls == b.calls and a.fires > 0


def _reference_engine(knobs, plan=None):
    return JEngine(get_smoke("llama2-7b"), impl="ref", faults=plan,
                   rng=jax.random.PRNGKey(21), **knobs)


def test_nan_injection_survivors_equal_the_reference_engine(donor):
    """The mixed prefill + decode batch of the isolation test, NaN
    injected into request 1's third sample, on both packages with the
    JAX weights: the same request fails at the same output, and every
    survivor's tokens are equal."""
    cfg, params = donor
    jeng0 = JEngine(get_smoke("llama2-7b"), max_slots=1, max_seq_len=16)
    runs = []
    for kind in ("jax", "port"):
        mk = JRequest if kind == "jax" else Request
        reqs = ([mk(prompt=[3 + i] * (4 + 2 * i), max_new_tokens=10)
                 for i in range(3)] + [mk(prompt=[9] * 36, max_new_tokens=4)])
        R = JFaultRule if kind == "jax" else FaultRule
        P = JFaultPlan if kind == "jax" else FaultPlan
        plan = P([R(site="sample", kind="nan", rid=reqs[1].rid, nth=3)])
        knobs = dict(max_slots=4, max_seq_len=64, prefill_chunk=4,
                     faults=plan)
        if kind == "jax":
            eng = JEngine(get_smoke("llama2-7b"), params=jeng0.params,
                          rng=jax.random.PRNGKey(21), **knobs)
        else:
            eng = Engine(cfg, params=params, **knobs)
        eng.generate(reqs, max_steps=300)
        runs.append((eng, reqs))
    (jeng, jreqs), (eng, reqs) = runs
    assert [r.status.value for r in reqs] == [r.status.value for r in jreqs]
    assert reqs[1].status is Status.FAILED and len(reqs[1].output) == 2
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert eng.robustness_report() == jeng.robustness_report()
    assert eng.steps == jeng.steps


def test_transient_retry_and_watermark_equal_the_reference_engine(donor):
    """A transient decode fault retried, then a watermark shed: the port's
    tokens, counters and ``Backpressure`` equal the JAX engine's."""
    cfg, params = donor
    jeng0 = JEngine(get_smoke("llama2-7b"), max_slots=1, max_seq_len=16)
    out = []
    for kind in ("jax", "port"):
        mk = JRequest if kind == "jax" else Request
        R = JFaultRule if kind == "jax" else FaultRule
        P = JFaultPlan if kind == "jax" else FaultPlan
        plan = P([R(site="decode", kind="transient", nth=3),
                  R(site="prefill", kind="transient", nth=1)])
        knobs = dict(max_slots=2, max_seq_len=64, pool_tokens=64,
                     admit_watermark=0.5, faults=plan)
        if kind == "jax":
            eng = JEngine(get_smoke("llama2-7b"), params=jeng0.params,
                          rng=jax.random.PRNGKey(23), **knobs)
        else:
            eng = Engine(cfg, params=params, **knobs)
        req = mk(prompt=[5] * 30, max_new_tokens=8)
        eng.add_request(req)
        eng.step()
        with pytest.raises((Backpressure, JBackpressure)) as ei:
            eng.add_request(mk(prompt=[2] * 8, max_new_tokens=2))
        while not req.done:
            eng.step()
        out.append((req.output, eng.robustness_report(), ei.value.reason))
    assert out[1] == out[0]
    assert out[1][1]["transient_retries"] == 2 and out[1][1]["shed"] == 1
