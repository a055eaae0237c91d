"""Structured serving-error taxonomy (the PyTorch port's own copy).

Every failure the serving stack can produce is an ``EngineError`` subclass
carrying the request id it concerns (when there is one) plus free-form
``context`` fields, so callers can route failures per request instead of
tearing the engine down.  Names and base classes match ``repro.errors``
one for one, so callers can route failures the same way on either
package.  The contract is:

  * no *unstructured* exception ever escapes ``Engine.step()`` — anything
    unexpected is wrapped in ``InternalError`` (with ``__cause__`` kept);
  * failures attributable to one request (bad sampling params, NaN logits,
    deadline miss, allocation starvation with no recourse) fail *that*
    request (``Status.FAILED``, pages released) while the rest of the
    batch keeps decoding;
  * admission-time rejections are ``Backpressure`` — a structured
    "try again later" with a retry hint, never silent queue growth.

Several classes double-inherit the builtin exception their call site used
to raise (``ValueError`` / ``RuntimeError``): the taxonomy is a refinement
of the old surface, not a break — ``except ValueError`` call sites and the
pre-existing tests keep working.

This module sits below both ``core`` (allocator) and ``serving`` so either
layer may raise structured errors without an import cycle.
"""

from __future__ import annotations

from typing import Optional


class EngineError(Exception):
    """Base of every structured serving failure.

    Attributes:
      rid:      request id the failure concerns, or None for engine-level
                failures (e.g. a transient device error on the whole step).
      context:  free-form keyword details (resource, limit, observed, ...).
    """

    def __init__(self, message: str = "", *, rid: Optional[int] = None,
                 **context):
        self.message = message
        self.rid = rid
        self.context = context
        super().__init__(message)

    def __str__(self) -> str:  # "<msg> [rid=3 resource=pages]"
        tail = []
        if self.rid is not None:
            tail.append(f"rid={self.rid}")
        tail += [f"{k}={v}" for k, v in self.context.items()]
        return self.message + (f" [{' '.join(tail)}]" if tail else "")


class InvalidRequest(EngineError, ValueError):
    """The request is malformed (bad sampling params, bad shape): rejected
    at ``add_request`` time, before it holds any resources."""


class EngineConfigError(EngineError, ValueError):
    """A build-time configuration is unusable: invalid engine/scheduler
    knob values, an unknown kernel backend or combine mode, an unknown
    model family / layer code / activation.  Raised while constructing the
    stack (never mid-step), before any request holds resources."""


class UnsupportedFeature(EngineError, NotImplementedError):
    """A structurally valid configuration asks for a combination the
    current implementation does not support yet (e.g. chunked prefill
    through recurrent layer families).  Distinct from ``EngineConfigError``:
    the config is legal, the capability is missing — callers can fall back
    (the engine drops to monolithic prefill paths) instead of erroring."""


class DistributedSetupError(EngineError, RuntimeError):
    """The distributed layer cannot resolve its environment: a named mesh
    axis is undefined, no mesh context is active where one is required.
    Raised at trace/setup time by ``repro.distributed``, not mid-collective."""


class RequestTooLong(InvalidRequest):
    """prompt + max_new_tokens exceeds the engine's ``max_seq_len`` (also
    raised for forks whose child would outgrow the device block table)."""


class PoolExhausted(EngineError, RuntimeError):
    """A page/slot reservation could not be served and no preemption
    candidate exists — the starved *request* fails; the engine lives on."""


class NumericsError(EngineError):
    """The numerics guard found non-finite (NaN/Inf) logits in this
    request's row.  The poisoned request fails; co-batched rows are
    unaffected (per-row isolation is gated by ``tests/test_faults.py``)."""


class SchedulerInvariantError(EngineError, RuntimeError):
    """An internal scheduler/allocator invariant broke: double free,
    free of an unknown rid, a block-table row outgrowing the device
    table.  Indicates a bug (or an injected allocator fault), never user
    error — surfaced loudly instead of silently corrupting the free list."""


class DeadlineExceeded(EngineError):
    """The request ran past its ``deadline_steps`` (or produced no first
    token within ``ttft_deadline_steps``) and was failed by the scheduler."""


class TransientDeviceError(EngineError):
    """A (possibly injected) transient device failure on a prefill/decode
    dispatch.  ``Engine.step`` retries the dispatch with backoff up to
    ``max_step_retries`` times before letting this escape."""


class InternalError(EngineError, RuntimeError):
    """Wrapper for any *unstructured* exception caught escaping
    ``Engine.step()`` — keeps the original as ``__cause__``."""


class Backpressure(EngineError):
    """Structured admission rejection (bounded queue full, or pool above
    the admission high-watermark).  Carries a retry hint so clients can
    back off instead of hammering a saturated engine.

    Attributes:
      reason:            "queue_full" | "pool_watermark"
      retry_after_steps: engine-step estimate before retrying is useful
      queue_depth:       waiting-queue length at rejection time
      pool_util:         pool utilisation in [0, 1] at rejection time
    """

    def __init__(self, message: str = "", *, reason: str = "queue_full",
                 retry_after_steps: int = 1, queue_depth: int = 0,
                 pool_util: float = 0.0, **context):
        super().__init__(message, reason=reason,
                         retry_after_steps=retry_after_steps,
                         queue_depth=queue_depth,
                         pool_util=round(pool_util, 4), **context)
        self.reason = reason
        self.retry_after_steps = retry_after_steps
        self.queue_depth = queue_depth
        self.pool_util = pool_util
