"""Serving request objects + lifecycle states (a copy of ``repro.serving.request``).

Lifecycle::

                    admit                 last chunk
    WAITING ─────────────▶ PREFILLING ───────────────▶ RUNNING ──▶ FINISHED
       ▲  ▲ (monolithic: straight to RUNNING)            │
       │  └──────────────── re-queue ◀── PREEMPTED ◀─────┘
       │
      add                 every non-terminal state may also exit to:
                            FAILED     (structured EngineError on `error`)
                            CANCELLED  (Engine.cancel_request)

``FAILED`` / ``CANCELLED`` / ``FINISHED`` are terminal: pages, slot and
block-table row are released on entry and the request never re-enters the
scheduler.  ``done`` is true for all three — callers draining a wave must
not spin on a request that can no longer make progress.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

_ids = itertools.count()


class Status(enum.Enum):
    WAITING = "waiting"        # queued, no pages reserved
    PREFILLING = "prefilling"  # in the batch, prompt caching chunk-by-chunk
    RUNNING = "running"        # in the decode batch
    PREEMPTED = "preempted"    # pages reclaimed; will re-prefill
    FINISHED = "finished"
    FAILED = "failed"          # terminal: structured error on req.error
    CANCELLED = "cancelled"    # terminal: torn down by cancel_request


# terminal states: resources released, never scheduled again
TERMINAL = (Status.FINISHED, Status.FAILED, Status.CANCELLED)


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 64
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    # deadlines (enforced by the scheduler; miss => FAILED/DeadlineExceeded)
    deadline_steps: Optional[int] = None       # total engine-step budget
    ttft_deadline_steps: Optional[int] = None  # steps until first token
    # set by the engine
    rid: int = field(default_factory=lambda: next(_ids))
    status: Status = Status.WAITING
    slot: int = -1                     # batch slot while RUNNING/PREFILLING
    prefill_pos: int = 0               # tokens cached so far (chunked prefill)
    cached_prefix: int = 0             # tokens served from the global prefix
    #                                    cache at the latest admission (0 =
    #                                    cold prefill); set by the scheduler
    #                                    even on re-admission after preempt
    output: List[int] = field(default_factory=list)
    parent: Optional[int] = None       # prefix-shared parent request id
    metrics: Dict[str, float] = field(default_factory=dict)
    error: Optional[Exception] = None  # EngineError when status is FAILED

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def total_len(self) -> int:
        return len(self.prompt) + len(self.output)

    @property
    def done(self) -> bool:
        """Terminal — finished, failed, or cancelled (no more progress)."""
        return self.status in TERMINAL

    @property
    def succeeded(self) -> bool:
        return self.status is Status.FINISHED
