"""Deterministic fault injection for the serving stack (the port's own copy
of the JAX package's ``repro.faults``).  It arms every point the port
wires; the rollout orchestrator's ``worker`` point waits for the port of
``async_rl``'s orchestrator, and a spec that names it fails at
construction instead of never firing.

A fault-tolerant engine is only as trustworthy as the failure modes it
has actually been driven through.  This module provides NAMED injection
points threaded through the allocator, the scheduler, the async
front-end, the heartbeat monitor and the disaggregated server, each
firing on a schedule that is a pure function of ``(spec, seed)``, so every
failure scenario replays byte-identically.

Injection points wired in the port:

  ============  ======================================  =================
  point         where it fires                          effect
  ============  ======================================  =================
  ``alloc``     ``PagedKVCache.alloc``                  raises CacheFull
                                                        (an alloc storm)
  ``admit``     ``ContinuousEngine._try_admit`` entry   per-request fault
                                                        (engine isolates)
  ``prefill``   ``ContinuousEngine._prefill_span``      per-request fault
                entry                                   (engine isolates)
  ``step``      ``ContinuousEngine.step`` entry         engine-level fault
                                                        (supervisor
                                                        restarts)
  ``slow``      ``ContinuousEngine.step`` entry         sleeps ``param``
                                                        seconds (deadline
                                                        pressure)
  ``crash``     ``AsyncFrontend`` serve loop            serve-thread crash
                                                        (supervisor
                                                        restarts)
  ``beat``      ``HeartbeatMonitor.beat``               beat swallowed (a
                                                        lapsing server)
  ``xfer``      ``MigrationChannel.migrate``            KV-block migration
                                                        attempt fails;
                                                        ``=x`` stalls the
                                                        install half x
                                                        seconds instead
                                                        (whole-attempt
                                                        timeout trips)
  ``route``     ``DisaggServer`` admission router       routing decision
                                                        hedged: the
                                                        request goes
                                                        colocated
  ============  ======================================  =================

Spec grammar (``REPRO_FAULTS``): comma-separated clauses, each

  * ``point@i``        — fire on the i-th call of that point (0-based);
  * ``point@i..j``     — fire on calls i through j inclusive (a storm);
  * ``point~p``        — fire each call with probability ``p`` drawn from
    a per-point PRNG seeded by ``(seed, point)`` — deterministic given
    the call sequence, independent of other points' call counts;
  * any clause may carry ``=x`` to attach a float parameter (read back
    via ``param()``; e.g. ``slow@3..5=0.05`` sleeps 50 ms).

``REPRO_FAULTS_SEED`` (int, default 0) seeds the ``~p`` draws.  An empty
spec disables everything: ``fires()`` is a dict lookup + early return,
cheap enough to leave in the hot path.

The spec is VALIDATED at construction: an unknown point name or a
malformed range/probability/parameter raises ``ValueError`` naming the
bad clause — a typo in ``REPRO_FAULTS`` must fail the run loudly, not
silently arm nothing.  ``KNOWN_POINTS`` lists the wired points; an
embedder adding its own sites passes ``points=`` to extend the set.

Example::

    REPRO_FAULTS="alloc@4..7,prefill@2,step@30,crash@55,slow~0.1=0.02"

injects a four-call alloc storm, one isolated per-request prefill fault,
one engine-level step exception (supervisor restart), one serve-loop
crash, and a 10% chance of a 20 ms slow step — identically on every run.
"""
from __future__ import annotations

import random
import zlib
from typing import Dict, List, Optional, Tuple


class InjectedFault(RuntimeError):
    """An injection point fired (a deterministic test fault).

    Carries the ``point`` name, the 0-based call index ``n`` it fired on,
    and (when the site can attribute it) the faulting request's ``rid`` —
    which is what lets the scheduler / front-end isolate the failure to
    one request instead of killing the engine."""

    def __init__(self, point: str, n: int, rid: Optional[int] = None):
        self.point = point
        self.n = n
        self.rid = rid
        at = f" rid={rid}" if rid is not None else ""
        super().__init__(f"injected fault: {point}@{n}{at}")


# Every injection point wired in the port.  _parse validates clause
# point names against this set so a REPRO_FAULTS typo fails loudly.
KNOWN_POINTS = frozenset({
    "alloc", "admit", "prefill", "step", "slow", "crash", "beat", "xfer",
    "route",
})
# Points of the reference that the port does not wire yet, with the reason
# a spec naming one is refused.
_NOT_WIRED = {"worker": "the rollout orchestrator's worker point is not "
                        "wired until async_rl's orchestrator is ported"}


class FaultInjector:
    """Named injection points firing on a deterministic schedule."""

    def __init__(self, spec: str = "", seed: int = 0,
                 points: frozenset = KNOWN_POINTS):
        self.spec = spec
        self.seed = seed
        self._points = points
        self._ranges: Dict[str, List[Tuple[int, int]]] = {}
        self._prob: Dict[str, float] = {}
        self._param: Dict[str, float] = {}
        self._rng: Dict[str, random.Random] = {}
        self.calls: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            self._parse(clause)
        # disabled injectors cost one attribute check at each site
        self.enabled = bool(self._ranges or self._prob)

    def _bad(self, clause: str, why: str) -> ValueError:
        return ValueError(f"bad fault clause {clause!r}: {why} "
                          f"(spec {self.spec!r})")

    def _check_point(self, point: str, clause: str) -> str:
        if not point:
            raise self._bad(clause, "empty point name")
        if point not in self._points:
            why = f" ({_NOT_WIRED[point]})" if point in _NOT_WIRED else ""
            raise self._bad(
                clause, f"unknown point {point!r}{why}; known points: "
                f"{', '.join(sorted(self._points))}")
        return point

    def _parse(self, clause: str) -> None:
        orig = clause
        if "=" in clause:
            clause, val = clause.split("=", 1)
            point = clause.split("@")[0].split("~")[0]
            try:
                self._param[point] = float(val)
            except ValueError:
                raise self._bad(orig, f"parameter {val!r} is not a float") \
                    from None
        if "@" in clause:
            point, when = clause.split("@", 1)
            self._check_point(point, orig)
            if "~" in when:
                raise self._bad(orig, "mixes @ (call index) with ~ "
                                      "(probability); pick one")
            lo, _, hi = when.partition("..")
            try:
                lo = int(lo)
                hi = int(hi) if hi else lo
            except ValueError:
                raise self._bad(orig, f"range {when!r} is not "
                                      f"an int or int..int") from None
            if lo < 0 or hi < lo:
                raise self._bad(orig, f"range {when!r} must satisfy "
                                      f"0 <= i <= j")
            self._ranges.setdefault(point, []).append((lo, hi))
        elif "~" in clause:
            point, p = clause.split("~", 1)
            self._check_point(point, orig)
            try:
                prob = float(p)
            except ValueError:
                raise self._bad(orig, f"probability {p!r} is not a float") \
                    from None
            if not 0.0 <= prob <= 1.0:
                raise self._bad(orig, f"probability {prob} outside [0, 1]")
            self._prob[point] = prob
            # a per-point PRNG keyed on (seed, point): the draw sequence
            # depends only on how often THIS point is hit, never on the
            # interleaving with other points
            self._rng[point] = random.Random(
                (self.seed << 32) ^ zlib.crc32(point.encode()))
        elif clause:
            # bare "point" = fire every call
            self._check_point(clause, orig)
            self._ranges.setdefault(clause, []).append((0, 1 << 62))

    @classmethod
    def from_env(cls) -> "FaultInjector":
        """Build an injector from ``REPRO_FAULTS`` / ``REPRO_FAULTS_SEED``
        (a fresh instance — schedules restart with each new consumer)."""
        from repro_torch.flags import fault_seed, fault_spec
        return cls(fault_spec(), fault_seed())

    # ------------------------------------------------------------------ api
    def armed(self, point: str) -> bool:
        return point in self._ranges or point in self._prob

    def fires(self, point: str) -> bool:
        """Advance ``point``'s call counter; True when this call faults."""
        if not self.enabled or not self.armed(point):
            return False
        n = self.calls.get(point, 0)
        self.calls[point] = n + 1
        hit = any(lo <= n <= hi for lo, hi in self._ranges.get(point, ()))
        if not hit and point in self._prob:
            hit = self._rng[point].random() < self._prob[point]
        if hit:
            self.fired[point] = self.fired.get(point, 0) + 1
        return hit

    def check(self, point: str, rid: Optional[int] = None) -> None:
        """Raise ``InjectedFault`` when ``point`` fires this call."""
        if self.fires(point):
            raise InjectedFault(point, self.calls[point] - 1, rid=rid)

    def param(self, point: str, default: float) -> float:
        """The ``=x`` parameter attached to ``point`` (e.g. slow-step
        seconds), or ``default``."""
        return self._param.get(point, default)

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return (f"FaultInjector(spec={self.spec!r}, seed={self.seed}, "
                f"fired={self.fired})")
