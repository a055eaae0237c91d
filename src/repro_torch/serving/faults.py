"""Deterministic, seeded fault injection for the serving stack (a copy of
``repro.serving.faults``).

Production paged-KV servers treat allocator failure, device flakiness and
numerics corruption as first-class, *tested* paths (PagedAttention makes
preempt-and-recover a scheduling primitive; vAttention's critique is
precisely that dynamic KV allocation failing mid-stream is where fragile
engines die).  This module makes those paths exercisable on demand:

  * a ``FaultPlan`` is a seeded list of ``FaultRule``s; each rule names an
    injection *site*, a fault *kind*, and when to fire (the nth matching
    call, or a probability drawn from the plan's private seeded RNG — no
    global randomness, so a given (plan, schedule) pair replays exactly);
  * ``FaultyPageManager`` wraps ``HostPageManager.reserve/extend/free``
    with the plan (forced allocation failure looks exactly like a dry
    pool; an injected ``free`` fault raises a structured allocator error);
  * the engine consults the plan at the prefill/decode dispatch (simulated
    transient device error, retried with backoff) and per request row at
    sampling time (injected NaN logits, caught by the numerics guard).

Injection sites and the fault kinds they accept:

  ========  ===========  ==================================================
  site      kind         effect
  ========  ===========  ==================================================
  reserve   alloc_fail   ``mgr.reserve`` returns False (dry-pool shaped)
  extend    alloc_fail   ``mgr.extend`` returns False (dry-pool shaped)
  free      error        ``mgr.free`` raises SchedulerInvariantError
  prefill   transient    prefill dispatch raises TransientDeviceError
  decode    transient    decode dispatch raises TransientDeviceError
  sample    nan          that request's logits row is set to NaN
  attach    evict        prefix-cache chain evicted between lookup and
                         attach (admission degrades to a cold prefill)
  ========  ===========  ==================================================

All faults fire *before* the wrapped operation mutates anything, so a
retried dispatch (transient) or a refused reservation (alloc_fail) leaves
the allocator state exactly as a real dry pool / flaky device would — the
allocator invariants asserted by the chaos soak hold across every fire.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core.paging import HostPageManager
from repro_torch.errors import EngineConfigError, SchedulerInvariantError

SITES = ("reserve", "extend", "free", "prefill", "decode", "sample",
         "attach")
KINDS = ("alloc_fail", "transient", "nan", "error", "evict")
_VALID = {
    "reserve": ("alloc_fail",),
    "extend": ("alloc_fail",),
    "free": ("error",),
    "prefill": ("transient",),
    "decode": ("transient",),
    "sample": ("nan",),
    # prefix-cache attach (core.prefix_cache): the matched chain is
    # evicted between lookup and attach — admission must degrade to a
    # plain cold prefill with nothing leaked
    "attach": ("evict",),
}


@dataclass
class FaultRule:
    """One injection rule.  Fires on the ``nth`` call matching
    (site, rid), or with probability ``prob`` per matching call; at most
    ``times`` fires total (None = unlimited)."""

    site: str
    kind: str
    rid: Optional[int] = None     # restrict to one request (sites that
    #                               carry a rid: reserve/extend/free/sample)
    nth: Optional[int] = None     # 1-based index among matching calls
    prob: float = 0.0             # used only when nth is None
    times: Optional[int] = 1      # max fires (None = unlimited)
    # counters (owned by the plan; one plan instance per engine run)
    seen: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)


class FaultPlan:
    """A seeded, replayable schedule of injected faults.

    The plan owns a private ``random.Random(seed)``; probability draws
    consume it only when a prob-rule is consulted, so for a deterministic
    engine schedule the fire pattern is a pure function of (seed, rules).
    ``plan.log`` records every fire as (site, rid, kind, call_index) for
    test assertions; ``plan.calls`` counts consultations per site.
    """

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        for r in rules:
            if r.site not in SITES:
                raise EngineConfigError(f"unknown fault site {r.site!r}; "
                                        f"sites: {SITES}", site=r.site)
            if r.kind not in _VALID[r.site]:
                raise EngineConfigError(
                    f"fault kind {r.kind!r} invalid at site {r.site!r}; "
                    f"valid: {_VALID[r.site]}", site=r.site, kind=r.kind)
        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        self.log: List[Tuple[str, Optional[int], str, int]] = []
        self.calls = {s: 0 for s in SITES}

    def fire(self, site: str, rid: Optional[int] = None) -> Optional[str]:
        """Consult the plan at an injection point.  Returns the fault kind
        to apply, or None.  At most one rule fires per call (first match
        in rule order wins)."""
        self.calls[site] += 1
        for rule in self.rules:
            if rule.site != site:
                continue
            if rule.rid is not None and rid != rule.rid:
                continue
            rule.seen += 1
            if rule.times is not None and rule.fired >= rule.times:
                continue
            if rule.nth is not None:
                hit = rule.seen == rule.nth
            else:
                hit = self._rng.random() < rule.prob
            if hit:
                rule.fired += 1
                self.log.append((site, rid, rule.kind, self.calls[site]))
                return rule.kind
        return None

    @property
    def fires(self) -> int:
        return len(self.log)


class FaultyPageManager(HostPageManager):
    """``HostPageManager`` with the plan's reserve/extend/free sites wired
    in.  Injected allocation failures are indistinguishable from a dry
    pool (return False, no mutation), so every scheduler recovery path —
    stall, preempt, backpressure, fail — is exercised by the same code
    that handles real exhaustion."""

    def __init__(self, num_pages: int, page_size: int, plan: FaultPlan):
        super().__init__(num_pages, page_size)
        self.plan = plan

    def reserve(self, seq_id: int, new_len: int) -> bool:
        if self.plan.fire("reserve", rid=seq_id) == "alloc_fail":
            return False
        return super().reserve(seq_id, new_len)

    def extend(self, seq_id: int, n_tokens: int = 1) -> bool:
        if self.plan.fire("extend", rid=seq_id) == "alloc_fail":
            return False
        # bypass the faulty `reserve` override: an extend is one logical
        # allocation and must consult the plan exactly once
        return HostPageManager.reserve(
            self, seq_id, self.lens.get(seq_id, 0) + n_tokens)

    def free(self, seq_id: int) -> None:
        if self.plan.fire("free", rid=seq_id) == "error":
            raise SchedulerInvariantError(
                f"injected allocator fault freeing rid {seq_id}",
                rid=seq_id, injected=True)
        super().free(seq_id)
