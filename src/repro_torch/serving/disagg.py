"""Live disaggregated prefill/decode serving (GLM-5 §3.6.2).

Port of ``repro.serving.disagg``.  Both tiers serve from ONE ``nn.Module``
(one copy of the weights on the card) with a pool each; each tier's
serve thread launches its own kernels.  ``bind_dp_router`` wires the
tiers' health signal (``health_callbacks``) into
``repro_torch.async_rl.router.DPRouter``'s hash ring.

Two live ``ContinuousEngine``s behind one front door: a PREFILL tier
that fills paged KV blocks and a DECODE tier that streams tokens, glued
by the ``MigrationChannel`` (``repro_torch.serving.migrate``) and an
admission router.  Long prompts prefill on the prefill tier (one
discarded greedy token drives the engine's normal prefill + radix
insert), their KV blocks migrate into the decode pool, and the decode
tier admits the full request against the migrated prefix — so heavy
prefills never steal decode steps from live token streams, which is the
whole point of the split (and of ``pd_sim.py``, the analytical model
this promotes to live engines).

Robustness is the headline — the degradation ladder, top to bottom:

  1. HEALTHY: long prompts (``pd_threshold`` tokens or more) go
     prefill-tier -> migrate -> decode; short prompts prefill colocated
     on the decode engine.
  2. MIGRATION FAILURE (injected ``xfer`` fault, timeout, version skew,
     decode-pool pressure): bounded retries with backoff, then the
     request falls back to COLOCATED prefill on the decode engine —
     the migration is an optimization, never a correctness dependency.
  3. PREFILL TIER DOWN (serve-thread crash, or heartbeat lapse): the
     router flips to degraded mode (``disagg.degraded_mode`` gauge) and
     serves EVERYTHING colocated; in-flight prefill-tier requests are
     resubmitted colocated (their decode side never started, so no
     output is lost or duplicated).  A crashed tier is respawned after
     ``respawn_delay_s`` (bounded by ``tier_restarts``), and the router
     FAILS BACK to the split the moment the tier is healthy again.
  4. DECODE TIER CRASH: the decode frontend's own supervisor
     restarts it up to its ``max_restarts``; past that the server is
     dead and says so — there is nothing left to degrade to.

Health is observed, not assumed: every router tick sends a liveness
probe through each frontend's ``call`` queue (the probe only lands when
the serve thread actually runs — a wedged thread lapses even though it
holds the GIL happily), and a ``HeartbeatMonitor`` sweep turns lapses
into tier-down transitions.  ``route`` is a deterministic fault point
(``repro_torch.faults``) that hedges a routing decision to colocated —
exercising the fallback path without breaking anything.

Fault-injector scoping: the ROUTER injector (``faults``, default from
``REPRO_FAULTS``) arms ``xfer``/``route``; the PREFILL tier gets its own
injector (``prefill_faults``, default from env — a ``crash@i`` clause
crashes the prefill serve thread); the DECODE tier defaults to DISABLED
so an injected outage hits the tier that can degrade, not the tier of
last resort.  Pass ``decode_faults`` explicitly to fault the decode
engine too.

Zero-lost contract: every submitted request reaches a terminal state
with its bytes identical to a single-engine oracle, under any
interleaving of migration faults and one prefill-tier crash.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.async_rl.heartbeat import HeartbeatMonitor
from repro_torch.faults import FaultInjector
from repro_torch.obs.metrics import MetricsRegistry, StatsView
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import Request
from repro_torch.serving.errors import MigrationFailed, RequestCancelled
from repro_torch.serving.frontend import (AsyncFrontend, FrontendClosed,
                                          PollResult)
from repro_torch.serving.migrate import MigrationChannel
from repro_torch.serving.scheduler import ContinuousEngine

PREFILL, DECODE = "prefill", "decode"


class _DisaggTicket:
    __slots__ = ("handle", "prompt", "max_new", "temperature", "deadline_s",
                 "t0", "state", "prefill_handle", "decode_handle", "routed",
                 "error", "path", "cancelled")

    def __init__(self, handle: int, prompt: List[int], max_new: int,
                 temperature: float, deadline_s: Optional[float]):
        self.handle = handle
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.deadline_s = deadline_s
        self.t0 = time.perf_counter()   # SLO clock spans BOTH tiers
        self.state = "queued"           # queued|prefilling|routed
        self.prefill_handle: Optional[int] = None
        self.decode_handle: Optional[int] = None
        # set once the ticket has a decode-side handle OR a terminal
        # error — result() waits on this, then delegates to the decode
        # frontend (the tier every surviving path ends on)
        self.routed = threading.Event()
        self.error: Optional[Exception] = None
        self.path = "?"                 # pd|colocated|degraded|fallback
        self.cancelled = False


class DisaggServer:
    """Admission router + prefill tier + decode tier, one front door."""

    def __init__(self, cfg, params, *,
                 decode_kw: Optional[dict] = None,
                 prefill_kw: Optional[dict] = None,
                 pd_threshold: Optional[int] = None,
                 migrate_timeout_s: Optional[float] = None,
                 migrate_retries: Optional[int] = None,
                 migrate_backoff_s: Optional[float] = None,
                 tier_restarts: Optional[int] = None,
                 respawn_delay_s: float = 0.05,
                 heartbeat_timeout_s: float = 2.0,
                 poll_interval_s: float = 0.002,
                 faults: Optional[FaultInjector] = None,
                 prefill_faults: Optional[FaultInjector] = None,
                 decode_faults: Optional[FaultInjector] = None,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 health_callbacks: Sequence[Callable[[str, bool], None]]
                 = ()):
        from repro_torch.flags import (pd_threshold_default,
                                       tier_restarts_default, trace_enabled)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else Tracer(enabled=trace_enabled())
        self.pd_threshold = pd_threshold_default() if pd_threshold is None \
            else pd_threshold
        self.tier_restarts = tier_restarts_default() \
            if tier_restarts is None else tier_restarts
        self.respawn_delay_s = respawn_delay_s
        self._poll_s = poll_interval_s
        # router-level injector (xfer/route) — the disaggregation
        # machinery's own failure modes
        self.faults = FaultInjector.from_env() if faults is None else faults
        dkw = dict(decode_kw or {})
        dkw.setdefault("prefix_cache", True)
        pkw = dict(prefill_kw) if prefill_kw is not None else dict(dkw)
        pkw.setdefault("prefix_cache", True)
        # the decode engine SHARES the server registry: its engine.* keys
        # are the server's latency truth (latency_summary()).  The
        # prefill engine gets its OWN registry — StatsView maps both
        # engines onto the same "engine.*" names, so sharing one registry
        # would merge their counters into nonsense.
        self.prefill_registry = MetricsRegistry()
        decode_eng = ContinuousEngine(
            cfg, params, registry=self.registry, tracer=self.tracer,
            faults=decode_faults if decode_faults is not None
            else FaultInjector(""), **dkw)
        prefill_eng = ContinuousEngine(
            cfg, params, registry=self.prefill_registry, tracer=self.tracer,
            faults=prefill_faults if prefill_faults is not None
            else FaultInjector.from_env(), **pkw)
        # decode tier keeps its internal supervisor (a decode crash is
        # restart-or-die); the prefill tier runs with max_restarts=0 so
        # the FIRST crash surfaces as an observable tier outage and THIS
        # server owns the respawn/fail-back cycle
        self._decode_fe = AsyncFrontend(decode_eng)
        self._prefill_fe = AsyncFrontend(prefill_eng, max_restarts=0)
        self.channel = MigrationChannel(
            prefill_eng, decode_eng,
            timeout_s=migrate_timeout_s, max_retries=migrate_retries,
            backoff_s=migrate_backoff_s, faults=self.faults,
            registry=self.registry, tracer=self.tracer,
            run_src=lambda fn: self._call(self._prefill_fe, fn),
            run_dst=lambda fn: self._call(self._decode_fe, fn))
        self.monitor = HeartbeatMonitor(timeout_s=heartbeat_timeout_s,
                                        registry=self.registry)
        self.monitor.register(PREFILL)
        self.monitor.register(DECODE)
        self.health_callbacks: List[Callable[[str, bool], None]] = \
            list(health_callbacks)
        self.callback_errors: List[str] = []
        self.stats = StatsView(self.registry, "disagg", [
            "pd_routes", "colocated_routes", "degraded_served",
            "route_faults", "colocated_fallbacks", "tier_down_events",
            "prefill_respawns", "failbacks", "migrations",
            "migration_retries", "migration_failures", "migrated_blocks",
            "migrated_tokens"])
        self.registry.set_gauge("disagg.degraded_mode", 0)
        self.degraded = False
        self.crashed: Optional[BaseException] = None
        self._down_since: Optional[float] = None
        self._respawns = 0
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._inbox: List[_DisaggTicket] = []
        self._pending: List[_DisaggTicket] = []   # prefill-tier in flight
        self._tickets: Dict[int, _DisaggTicket] = {}
        self._handles = itertools.count()
        self._stop = False
        self._router = threading.Thread(target=self._router_loop,
                                        name="disagg-router", daemon=True)
        self._router.start()

    # ------------------------------------------------------------- clients
    def submit(self, prompt: Sequence[int], *, max_new: int = 32,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None) -> int:
        """Enqueue one request with the router; returns a handle.

        Geometry validates against the DECODE engine (every surviving
        path ends there) on the caller's thread, so impossible requests
        fail fast.  Routing happens asynchronously — admission
        backpressure from a tier surfaces as a typed error at
        ``result()``, never as a lost request."""
        toks = [int(x) for x in prompt]
        probe = Request(prompt=np.asarray(toks, np.int32), max_new=max_new,
                        temperature=temperature)
        self._decode_fe.engine.validate(probe)
        t = _DisaggTicket(next(self._handles), toks, max_new, temperature,
                          deadline_s)
        with self._work:
            if self._stop or self.crashed is not None:
                raise FrontendClosed(
                    f"disagg server is closed (crashed={self.crashed!r})")
            self._tickets[t.handle] = t
            self._inbox.append(t)
            self._work.notify()
        return t.handle

    def poll(self, handle: int) -> PollResult:
        """Non-blocking progress snapshot (empty while prefilling)."""
        with self._lock:
            t = self._tickets[handle]
            err, dh = t.error, t.decode_handle
        if dh is not None:
            return self._decode_fe.poll(dh)
        return PollResult(np.asarray([], np.int32), err is not None,
                          None, err)

    def result(self, handle: int, timeout: Optional[float] = None
               ) -> Request:
        """Block until the request finishes; returns it (or re-raises
        its typed failure).  On timeout the handle stays re-waitable."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            t = self._tickets[handle]
        if not t.routed.wait(timeout):
            raise TimeoutError(f"request {handle} still routing after "
                               f"{timeout}s (handle stays re-waitable)")
        if t.error is not None:
            with self._lock:
                self._tickets.pop(handle, None)
            raise t.error
        left = None if deadline is None \
            else max(0.0, deadline - time.perf_counter())
        req = self._decode_fe.result(t.decode_handle,
                                     None if timeout is None else left)
        with self._lock:
            self._tickets.pop(handle, None)
        return req

    def cancel(self, handle: int) -> bool:
        """Best-effort cancel across tiers: a decode-side request
        cancels there; one still queued/prefilling is failed by the
        router with ``RequestCancelled`` (its prefill sub-request is
        cancelled too — the migrated prefix, if any, stays cached)."""
        with self._work:
            t = self._tickets.get(handle)
            if t is None or t.error is not None:
                return False
            if t.decode_handle is not None:
                dh = t.decode_handle
            else:
                t.cancelled = True
                self._work.notify()
                return True
        return self._decode_fe.cancel(dh)

    def latency_summary(self) -> dict:
        """Live TTFT/TPOT/latency/queue percentiles as CLIENTS see them:
        the decode engine's histograms, with ``t_submit`` backdated to
        the router's front door so prefill-tier time counts."""
        return self._decode_fe.latency_summary()

    def close(self, timeout: Optional[float] = None) -> None:
        """Drain the router, then both tiers.  Idempotent."""
        with self._work:
            self._stop = True
            self._work.notify()
        self._router.join(timeout)
        self._prefill_fe.close(timeout)
        self._decode_fe.close(timeout)

    # convenience accessors (tests/benchmarks)
    @property
    def decode_frontend(self) -> AsyncFrontend:
        return self._decode_fe

    @property
    def prefill_frontend(self) -> AsyncFrontend:
        return self._prefill_fe

    @property
    def prefill_healthy(self) -> bool:
        return self._prefill_fe.crashed is None \
            and self.monitor.is_healthy(PREFILL)

    # ------------------------------------------------------- router thread
    @staticmethod
    def _call(fe: AsyncFrontend, fn):
        """Run ``fn`` on ``fe``'s serve thread and return its value
        (``AsyncFrontend.call`` only propagates exceptions)."""
        box = {}

        def run():
            box["v"] = fn()
        fe.call(run)
        return box["v"]

    def _router_loop(self) -> None:
        while True:
            with self._work:
                if not (self._stop or self._inbox or self._pending):
                    self._work.wait(timeout=self._poll_s)
                inbox, self._inbox = self._inbox, []
                stop = self._stop
            self._health_tick()
            for t in inbox:
                self._route(t)
            self._poll_prefills()
            if stop:
                with self._lock:
                    drained = not (self._inbox or self._pending)
                if drained:
                    return
            if self._pending:
                # outstanding prefill-tier work: poll at cadence instead
                # of spinning (completions land via the tier's threads)
                time.sleep(self._poll_s)

    def _route(self, t: _DisaggTicket) -> None:
        """Classify one request: prefill-tier path or colocated."""
        if t.cancelled:
            self._fail(t, RequestCancelled(
                f"request {t.handle} cancelled before routing"))
            return
        plen = len(t.prompt)
        use_pd = plen >= self.pd_threshold and not self.degraded \
            and self._prefill_fe.crashed is None
        if use_pd and self.faults.enabled and self.faults.fires("route"):
            # injected routing hedge: serve colocated, count it —
            # exercising the fallback without hurting anyone
            self.stats["route_faults"] += 1
            use_pd = False
        if use_pd:
            try:
                # the prefill tier must also be able to hold the prompt
                self._prefill_fe.engine.validate(
                    Request(prompt=np.asarray(t.prompt, np.int32),
                            max_new=1))
                # max_new=1: the engine's normal serve path prefills the
                # whole prompt and inserts its blocks into the tier's
                # radix tree on finish; the one greedy token is
                # discarded (the decode tier recomputes it identically)
                t.prefill_handle = self._prefill_fe.submit(
                    t.prompt, max_new=1, t_submit=t.t0)
                t.state = "prefilling"
                t.path = "pd"
                self.stats["pd_routes"] += 1
                self._pending.append(t)
                return
            except Exception:           # noqa: BLE001 - tier refused: hedge
                pass
        t.path = "degraded" if self.degraded and plen >= self.pd_threshold \
            else "colocated"
        self._submit_decode(t)

    def _poll_prefills(self) -> None:
        still: List[_DisaggTicket] = []
        for t in self._pending:
            if t.cancelled:
                try:
                    self._prefill_fe.cancel(t.prefill_handle)
                    self._prefill_fe.detach(t.prefill_handle)
                except Exception:       # noqa: BLE001 - tier may be dead
                    pass
                self._fail(t, RequestCancelled(
                    f"request {t.handle} cancelled while prefilling"))
                continue
            try:
                pr = self._prefill_fe.poll(t.prefill_handle)
            except KeyError:
                pr = None               # tier respawned under us
            if pr is not None and not pr.done:
                still.append(t)
                continue
            self._prefill_fe.detach(t.prefill_handle)
            if pr is None or pr.error is not None:
                # the prefill tier died under this request (crash /
                # restart / isolated fault).  Its decode side never
                # started, so resubmitting colocated cannot duplicate
                # output — this is the zero-lost hedge.
                self.stats["colocated_fallbacks"] += 1
                t.path = "fallback"
                self._submit_decode(t)
                continue
            try:
                self.channel.migrate(t.prompt)
            except MigrationFailed:
                # retries exhausted: decode prefills this prompt cold —
                # slower, never wrong
                self.stats["colocated_fallbacks"] += 1
                t.path = "fallback"
            self._submit_decode(t)
        self._pending = still

    def _submit_decode(self, t: _DisaggTicket) -> None:
        """Land a ticket on the decode tier (the terminal tier for every
        path).  A submit failure is a typed terminal outcome, never a
        stranded ticket."""
        try:
            dh = self._decode_fe.submit(
                t.prompt, max_new=t.max_new, temperature=t.temperature,
                deadline_s=t.deadline_s, t_submit=t.t0)
        except Exception as e:          # noqa: BLE001 - typed at result()
            self._fail(t, e)
            return
        with self._lock:
            t.decode_handle = dh
            t.state = "routed"
        if t.path == "colocated":
            self.stats["colocated_routes"] += 1
        elif t.path == "degraded":
            self.stats["degraded_served"] += 1
        t.routed.set()

    def _fail(self, t: _DisaggTicket, e: Exception) -> None:
        with self._lock:
            t.error = e
            t.state = "routed"
        t.routed.set()

    # -------------------------------------------------------------- health
    def _health_tick(self) -> None:
        """Probe, sweep, transition, respawn — one pass per router tick."""
        for tier, fe in ((PREFILL, self._prefill_fe),
                         (DECODE, self._decode_fe)):
            if fe.crashed is None:
                try:
                    # register (not beat) as the probe: it both stamps
                    # liveness AND revives a tier the monitor evicted —
                    # a lapse that clears (wedged thread recovers) fails
                    # back without a respawn
                    fe.call(lambda tier=tier: self.monitor.register(tier),
                            wait=False)
                except FrontendClosed:
                    pass
        self.monitor.sweep()
        up = self.prefill_healthy
        if self.degraded and up:
            self._fail_back()
        elif not self.degraded and not up:
            self._tier_down()
        if self.degraded and self._prefill_fe.crashed is not None \
                and self._respawns < self.tier_restarts \
                and time.perf_counter() - (self._down_since or 0.0) \
                >= self.respawn_delay_s:
            self._respawn_prefill()
        if self._decode_fe.crashed is not None and self.crashed is None:
            # nothing left to degrade to: fail loudly, strand nobody
            self.crashed = self._decode_fe.crashed
            with self._lock:
                orphans = [t for t in self._tickets.values()
                           if t.decode_handle is None
                           and not t.routed.is_set()]
            for t in orphans:
                self._fail(t, FrontendClosed(
                    f"decode tier crashed: {self.crashed!r}"))

    def _tier_down(self) -> None:
        self.degraded = True
        self._down_since = time.perf_counter()
        self.stats["tier_down_events"] += 1
        self.registry.set_gauge("disagg.degraded_mode", 1)
        self.tracer.instant("disagg.tier_down", tier=PREFILL)
        self._notify_health(PREFILL, False)

    def _fail_back(self) -> None:
        self.degraded = False
        self._down_since = None
        self.stats["failbacks"] += 1
        self.registry.set_gauge("disagg.degraded_mode", 0)
        self.tracer.instant("disagg.fail_back", tier=PREFILL)
        self._notify_health(PREFILL, True)

    def _respawn_prefill(self) -> None:
        """Rebuild the crashed prefill tier (the engine's ``respawn``:
        shared registry/tracer/fault schedule, so a ``crash@i`` clause
        never re-fires, and the dead pool released first) and point the
        migration channel at the new engine."""
        old = self._prefill_fe
        self._respawns += 1
        try:
            old.close(timeout=0.5)      # crashed loop: join is immediate
        except Exception:               # noqa: BLE001 - best-effort
            pass
        eng = old.engine.respawn()
        self._prefill_fe = AsyncFrontend(eng, max_restarts=0)
        self.channel.src = eng
        self.monitor.register(PREFILL)
        self.stats["prefill_respawns"] += 1
        self.tracer.instant("disagg.tier_respawn", tier=PREFILL,
                            respawns=self._respawns)
        # fail-back happens on the next tick's health check, once the
        # new serve thread proves it is actually beating

    def _notify_health(self, tier: str, healthy: bool) -> None:
        for cb in self.health_callbacks:
            try:
                cb(tier, healthy)
            except Exception as e:      # noqa: BLE001 - isolated
                self.callback_errors.append(
                    f"health_callback({tier}, {healthy}): {e!r}")


def bind_dp_router(server: DisaggServer, router, tier_ranks: Dict[str, int]
                   ) -> None:
    """Wire the disagg health signal into a ``DPRouter`` hash ring: a
    tier going down drops its DP rank from the ring (its keyspace
    reroutes to healthy ranks), fail-back restores it.  ``tier_ranks``
    maps tier name (``"prefill"``/``"decode"``) -> rank index."""
    def cb(tier: str, healthy: bool) -> None:
        rank = tier_ranks.get(tier)
        if rank is None:
            return
        if healthy:
            router.restore_rank(rank)
        else:
            router.drop_rank(rank)
    server.health_callbacks.append(cb)
