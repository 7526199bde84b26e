"""Typed per-request error surface of the fault-tolerant serving stack.

Every way a request can terminally fail WITHOUT the engine dying gets
its own exception class, so clients (and the PD-disaggregation router
this substrate is built for) can branch on the failure mode instead of
string-matching a RuntimeError:

  * ``EngineOverloaded`` — admission backpressure: the bounded waiting
    queue is full and ``submit`` fast-fails instead of growing an
    unbounded backlog (raised on the CALLER's thread by
    ``AsyncFrontend.submit``, so a saturated engine is visible at the
    submission site, not minutes later);
  * ``RequestShed``      — preemptive load shedding: the pool is
    exhausted with an empty engine (e.g. every block pinned by
    sessions), so queued requests are shed deepest-first with a
    per-request error instead of the old engine-killing ``CacheFull``;
  * ``RequestCancelled`` — the client called ``cancel()``; a mid-flight
    cancellation donates its KV blocks through the radix path, so the
    cancelled prefix still seeds the cache;
  * ``DeadlineExceeded`` — the request's ``deadline_s`` elapsed (queued
    or mid-flight); blocks are donated like a cancellation;
  * ``EngineRestarted``  — the serve loop crashed and the supervisor
    rebuilt the engine: requests whose device state died with it fail
    with this, while un-started waiting requests are re-queued and never
    observe the crash;
  * ``MigrationFailed``  — a KV-block migration between disaggregated
    tiers could not complete (timeout, injected ``xfer`` fault, version
    skew, or decode-pool pressure) after its bounded retries.  The
    disagg router treats it as a ROUTING outcome, not a request outcome:
    it falls back to colocated prefill on the decode engine, so clients
    normally never see this type — it surfaces only when the
    ``MigrationChannel`` is driven directly.

All subclass ``ServingError`` (itself a ``RuntimeError``), so "any
fault-tolerance outcome" is one ``except`` clause.  The terminal state
of a request is readable off the ``Request`` itself: exactly one of
``req.out`` (success) or ``req.error`` (one of these, or the isolated
per-request fault that killed it) is set, with ``req.status`` naming the
outcome (``ok | failed | cancelled | deadline | shed | restarted``).
"""
from __future__ import annotations


class ServingError(RuntimeError):
    """Base class for typed per-request serving failures."""


class EngineOverloaded(ServingError):
    """Bounded waiting queue is full: submission fast-failed."""


class RequestShed(ServingError):
    """Load shedding: pool exhausted with an empty engine."""


class RequestCancelled(ServingError):
    """The client cancelled this request."""


class DeadlineExceeded(ServingError):
    """The request's ``deadline_s`` elapsed before completion."""


class EngineRestarted(ServingError):
    """A supervisor restart lost this request's in-flight state."""


class MigrationFailed(ServingError):
    """A prefill->decode KV-block migration exhausted its retry budget
    (timeout / injected fault / version skew / pool pressure).  The
    disagg router degrades to colocated prefill instead of failing the
    request."""
