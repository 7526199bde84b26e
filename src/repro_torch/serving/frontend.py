"""Async serving front-end: ``submit()`` / ``poll()`` over one engine.

Port of ``repro.serving.frontend`` (host code: the engine it drives runs
the kernels).

``ContinuousEngine`` already multiplexes many sequences over one decode
batch, but its driving API is a blocking turn-by-turn loop —
``serve(reqs)`` owns the caller's thread until the whole batch drains, so
nothing can join mid-flight and a trainer weight push has to wait at the
batch boundary.  ``AsyncFrontend`` inverts that: ONE background serve
thread owns the engine and steps it continuously, while any number of
client threads

  * ``submit(prompt, ...)`` a request at ANY time — it is admitted into
    the live decode batch at the next iteration boundary (continuous
    batching across callers, not just within one call);
  * ``poll(handle)`` the tokens streamed so far (non-blocking) or
    ``result(handle)`` the finished request (blocking);
  * ``push_weights(params, version)`` a new weight snapshot — applied by
    the engine at its drain barrier with INCREMENTAL prefix-cache
    invalidation (version-tagged blocks; see ``scheduler.push_weights``),
    never blocking the pusher and never resetting the world;
  * run multi-turn conversations through ``AsyncSession`` — the
    ``AgentSession`` semantics (prefill only the new message, pin the
    conversation's blocks between turns) with non-blocking turns.

Threading contract: the engine and every host-side structure under it
(allocator, radix tree, block tables) are touched ONLY by the serve
thread.  Client calls communicate through locked inboxes; completions
come back through per-ticket events.  ``Request.out_version`` stamps tell
every consumer exactly which weight snapshot produced a trajectory — the
drain barrier guarantees a single version per request even when pushes
land mid-run.

On the card the serve thread sets the engine's device and runs without
autograd (both are per thread in PyTorch); every kernel launches from it,
on its current stream.  A CUDA error (a failed launch, or an error of the
CUDA runtime) is not restarted: it may poison the context for good, and a
respawn on a poisoned context would only fail again, so the front-end
marks itself crashed at once.  ``Request.out_logprobs`` stays None:
logprob capture comes with the RL layers.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.engine import Request
from repro_torch.serving.errors import EngineOverloaded, EngineRestarted
from repro_torch.serving.scheduler import ContinuousEngine


def _device_error(e: BaseException) -> bool:
    """Is ``e`` an error of the card (which a respawn cannot clear)?"""
    if isinstance(e, getattr(torch, "AcceleratorError", ())):
        return True
    msg = str(e)
    return "CUDA error" in msg or "cudaError" in msg


class FrontendClosed(RuntimeError):
    """Raised by submit/push on a closed (or crashed) front-end."""


class PollResult:
    """Snapshot of one in-flight request: tokens streamed so far, the
    weight version serving it (None until admitted), completion flag, and
    the error that killed it (None normally)."""
    __slots__ = ("tokens", "done", "version", "error")

    def __init__(self, tokens: np.ndarray, done: bool,
                 version: Optional[int], error: Optional[Exception]):
        self.tokens = tokens
        self.done = done
        self.version = version
        self.error = error

    def __repr__(self):  # pragma: no cover - debugging sugar
        return (f"PollResult(n={len(self.tokens)}, done={self.done}, "
                f"version={self.version}, error={self.error!r})")


class _Ticket:
    __slots__ = ("handle", "req", "tokens", "version", "error", "done",
                 "on_finish")

    def __init__(self, handle: int, req: Request,
                 on_finish: Optional[Callable[[Request], None]]):
        self.handle = handle
        self.req = req
        self.tokens: List[int] = []        # streamed so far (out only)
        self.version: Optional[int] = None
        self.error: Optional[Exception] = None
        self.done = threading.Event()
        self.on_finish = on_finish


class AsyncFrontend:
    """Background serve thread multiplexing submit()/poll() clients and
    weight pushes over one ``ContinuousEngine``."""

    def __init__(self, engine: ContinuousEngine,
                 max_restarts: Optional[int] = None):
        self.engine = engine
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._inbox: List[_Ticket] = []          # awaiting engine.submit
        self._pushes: List[tuple] = []           # (params, version)
        self._calls: List[list] = []             # [fn, done_event, error]
        self._cancels: List[_Ticket] = []        # awaiting engine.cancel
        self._tickets: Dict[int, _Ticket] = {}   # handle -> ticket
        self._live: Dict[int, _Ticket] = {}      # id(req) -> ticket
        self._handles = itertools.count()
        self._stop = False
        self.crashed: Optional[BaseException] = None
        self.callback_errors: List[str] = []
        # serve-loop supervision: a crash rebuilds the engine (respawn)
        # up to ``max_restarts`` times (REPRO_MAX_RESTARTS default),
        # re-queuing un-started waiting requests and failing only those
        # whose in-flight device state died with the crash.  ``restarts``
        # counts them; ``generation`` bumps per rebuild so block pins
        # taken against an earlier engine's pool are recognizably dead.
        if max_restarts is None:
            from repro_torch.flags import max_restarts_default
            max_restarts = max_restarts_default()
        self.max_restarts = max_restarts
        self.restarts = 0
        self.generation = 0
        # the card the serve thread works on, resolved on the caller's
        # thread ("cuda" means this thread's current device)
        dev = engine.device
        self._cuda_index = None if dev.type != "cuda" else (
            dev.index if dev.index is not None
            else torch.cuda.current_device())
        self._thread = threading.Thread(target=self._serve_loop,
                                        name="serve-frontend", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- clients
    def submit(self, prompt: Sequence[int], *, max_new: int = 32,
               temperature: float = 0.0,
               deadline_s: Optional[float] = None,
               on_finish: Optional[Callable[[Request], None]] = None,
               t_submit: Optional[float] = None) -> int:
        """Enqueue one request; returns a handle for poll()/result().

        Safe from any thread at any time — the serve thread admits it
        into the continuous batch at the next iteration.  Geometry
        validation happens here, on the caller's thread, so impossible
        requests fail fast — as does admission backpressure: when the
        engine's bounded waiting queue (inbox included) is full this
        raises the typed ``EngineOverloaded`` at the submission site
        instead of burying the request in an unbounded backlog.
        ``deadline_s`` (seconds, relative to now) has the scheduler
        retire the request with ``DeadlineExceeded`` if it cannot finish
        in time.  ``on_finish(req)`` (if given) runs ON THE SERVE THREAD
        right after the request retires successfully, with the engine
        state consistent — the hook sessions use to pin blocks.
        ``t_submit`` backdates the TTFT/deadline clock to an earlier
        ``time.perf_counter()`` stamp — the disagg router uses it so a
        request's time in the prefill tier still counts toward the SLO
        it resubmits under."""
        req = Request(prompt=np.asarray(prompt, np.int32), max_new=max_new,
                      temperature=temperature, deadline_s=deadline_s)
        # TTFT clock starts HERE, on the caller's thread: time spent in
        # the inbox waiting for the serve thread is real latency the
        # client observes, so it must count toward the SLO
        req.t_submit = time.perf_counter() if t_submit is None else t_submit
        eng = self.engine
        eng.validate(req)
        with self._work:
            if self._stop or self.crashed is not None:
                raise FrontendClosed(f"front-end is closed "
                                     f"(crashed={self.crashed!r})")
            if eng.max_waiting is not None and \
                    len(eng.waiting) + len(self._inbox) >= eng.max_waiting:
                # caller-thread fast-fail: len() reads are atomic and the
                # bound is advisory here — the engine's own submit-time
                # check stays authoritative on the serve thread
                eng.registry.inc("engine.overloads")
                raise EngineOverloaded(
                    f"engine overloaded: {len(eng.waiting)} waiting + "
                    f"{len(self._inbox)} inboxed >= max_waiting "
                    f"{eng.max_waiting}")
            t = _Ticket(next(self._handles), req, on_finish)
            self._tickets[t.handle] = t
            self._inbox.append(t)
            self._work.notify()
        return t.handle

    def cancel(self, handle: int) -> bool:
        """Cancel one submitted request; best-effort, safe from any
        thread.  A request still in the inbox dies immediately; one the
        engine owns is retired at the next serve iteration (mid-flight
        KV donated to the prefix cache).  Returns False when the handle
        is unknown or the request already reached a terminal state —
        cancellation races completion, and whichever lands first wins
        (``result()`` then reports that outcome)."""
        from repro_torch.serving.errors import RequestCancelled
        with self._work:
            t = self._tickets.get(handle)
            if t is None or t.done.is_set():
                return False
            if t in self._inbox:
                # never reached the engine: fail the ticket inline (no
                # engine state to unwind).  Set fields directly — _fail
                # retakes the non-reentrant lock we hold.
                self._inbox.remove(t)
                t.req.error = RequestCancelled(
                    f"request {handle} cancelled before admission")
                t.req.status = "cancelled"
                t.req.t_finish = time.perf_counter()
                t.error = t.req.error
                self.engine.registry.inc("engine.cancels")
                t.done.set()
                return True
            self._cancels.append(t)
            self._work.notify()
        return True

    def detach(self, handle: int) -> None:
        """Forget a handle without waiting for it (e.g. after a
        ``result()`` timeout the caller gives up on).  The request keeps
        running — ``cancel()`` first to actually stop it; detaching only
        drops the ticket so an abandoned handle cannot pin its bookkeeping
        forever."""
        with self._lock:
            self._tickets.pop(handle, None)

    def push_weights(self, params, version: int) -> None:
        """Hand the engine a new weight snapshot; returns immediately.

        The serve thread forwards it to ``engine.push_weights`` — applied
        at the drain barrier, invalidating the prefix cache incrementally
        via the version tags.  Generation is never interrupted: in-flight
        requests drain at their admitted version, queued and future
        submissions pick up the new one."""
        with self._work:
            if self._stop or self.crashed is not None:
                raise FrontendClosed(f"front-end is closed "
                                     f"(crashed={self.crashed!r})")
            self._pushes.append((params, version))
            self._work.notify()

    def poll(self, handle: int) -> PollResult:
        """Non-blocking progress snapshot for one submitted request."""
        with self._lock:
            t = self._tickets[handle]
            return PollResult(np.asarray(t.tokens, np.int32),
                              t.done.is_set(), t.version, t.error)

    def result(self, handle: int, timeout: Optional[float] = None
               ) -> Request:
        """Block until the request finishes; returns it (``out``,
        ``out_logprobs``, ``out_version`` filled) and forgets the handle.
        A typed per-request failure (cancelled / deadline / shed /
        restarted / isolated fault) re-raises here, also forgetting the
        handle.  On TIMEOUT the handle stays registered and re-waitable —
        retry ``result()`` later, or ``detach()`` (optionally after
        ``cancel()``) to give up without leaking the ticket."""
        with self._lock:
            t = self._tickets[handle]
        if not t.done.wait(timeout):
            raise TimeoutError(f"request {handle} still running after "
                               f"{timeout}s (handle stays re-waitable; "
                               f"cancel()/detach() to abandon it)")
        with self._lock:
            self._tickets.pop(handle, None)
        if t.error is not None:
            raise t.error
        return t.req

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every request submitted so far has reached a
        terminal state (success OR typed failure).  ``timeout`` bounds
        the WHOLE flush, not each ticket; on expiry the unfinished
        tickets stay registered and re-waitable."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._lock:
            pending = [t for t in self._tickets.values()
                       if not t.done.is_set()]
        for t in pending:
            left = None if deadline is None \
                else deadline - time.perf_counter()
            if not t.done.wait(left):
                raise TimeoutError(f"request {t.handle} still running "
                                   f"after {timeout}s flush")

    def call(self, fn: Callable[[], None], *, wait: bool = True) -> None:
        """Run ``fn`` on the serve thread (engine state consistent there).

        An exception inside ``fn`` is ISOLATED: it re-raises here on the
        caller's thread (``wait=True``) or lands in ``callback_errors``
        (``wait=False``) — it never crashes the serve loop.

        Never call with ``wait=True`` FROM the serve thread (an
        ``on_finish`` hook) — that deadlocks; hooks already run there."""
        c = [fn, threading.Event() if wait else None, None]
        with self._work:
            if self._stop or self.crashed is not None:
                raise FrontendClosed("front-end is closed")
            self._calls.append(c)
            self._work.notify()
        if c[1] is not None:
            c[1].wait()
            if c[2] is not None:
                raise c[2]

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop accepting work, drain everything in flight, join the
        serve thread.  Idempotent."""
        with self._work:
            self._stop = True
            self._work.notify()
        self._thread.join(timeout)

    @property
    def version(self) -> int:
        """Engine weight version (the one new admissions run under)."""
        return self.engine.weight_version

    @property
    def stats(self) -> dict:
        return dict(self.engine.stats)

    @property
    def registry(self):
        """The engine's ``MetricsRegistry`` (TTFT/TPOT histograms etc.).

        Reads (snapshot/summary) are thread-safe; mutation belongs to the
        serving layers."""
        return self.engine.registry

    @property
    def tracer(self):
        return self.engine.tracer

    def latency_summary(self) -> dict:
        """Live TTFT/TPOT/latency/queue histogram summaries — measured
        from the CALLER's submit() call, across the serve thread."""
        return self.engine.latency_summary()

    def export_trace(self, path: Optional[str] = None) -> dict:
        """Export buffered trace events as Chrome trace-event JSON
        (viewable in Perfetto); empty if the tracer is disabled."""
        return self.engine.tracer.export(path)

    # -------------------------------------------------------- serve thread
    def _serve_loop(self) -> None:
        """Supervised serve loop: ``_run_engine`` until clean shutdown; a
        crash (anything the engine could not isolate to one request —
        e.g. an injected ``step``/``crash`` fault or a real device error)
        costs ONLY the in-flight requests: the supervisor respawns the
        engine, re-queues waiting requests that never started, and keeps
        serving.  Past ``max_restarts`` the front-end marks itself
        crashed and fails everything outstanding — a crash loop must not
        masquerade as a healthy server."""
        from repro_torch.flags import frontend_wait_s
        wait_s = frontend_wait_s()
        try:
            if self._cuda_index is not None:
                torch.cuda.set_device(self._cuda_index)
        except Exception as e:                  # noqa: BLE001
            self._mark_crashed(e)               # never a silent death
            return
        with torch.no_grad():
            while True:
                try:
                    self._run_engine(wait_s)
                    return
                except BaseException as e:      # noqa: BLE001 - serve crash
                    if self._stop or self.restarts >= self.max_restarts \
                            or _device_error(e):
                        # terminal: record the crash (submit/push raise
                        # FrontendClosed, every ticket fails) and exit the
                        # thread quietly — re-raising from a daemon thread
                        # only spews a traceback nobody can catch
                        self._mark_crashed(e)
                        return
                    try:
                        self._restart(e)
                    except Exception as e2:     # noqa: BLE001
                        # the respawn itself failed (e.g. no memory for
                        # the new pool): a crash loop, not a restart
                        self._mark_crashed(e2)
                        return

    def _run_engine(self, wait_s: float) -> None:
        while True:
            eng = self.engine            # rebinds after a restart
            with self._work:
                while not (self._stop or self._inbox or self._pushes
                           or self._calls or self._cancels or eng.busy):
                    self._work.wait(timeout=wait_s)
                if self._stop and not (self._inbox or self._pushes
                                       or self._calls or eng.busy):
                    return
                inbox, self._inbox = self._inbox, []
                pushes, self._pushes = self._pushes, []
                calls, self._calls = self._calls, []
                cancels, self._cancels = self._cancels, []
            for params, version in pushes:
                eng.push_weights(params, version)
            for c in calls:
                try:
                    c[0]()
                except Exception as e:          # noqa: BLE001 - isolated
                    c[2] = e
                    if c[1] is None:
                        self.callback_errors.append(f"call: {e!r}")
                finally:
                    if c[1] is not None:
                        c[1].set()
            for t in inbox:
                try:
                    eng.submit(t.req)
                    self._live[id(t.req)] = t
                except Exception as e:          # noqa: BLE001
                    self._fail(t, e)
            for t in cancels:
                if not t.done.is_set() and t.req.rid is not None:
                    eng.cancel(t.req.rid)
            if eng.busy:
                if eng.faults.enabled:
                    # "crash": the serve LOOP dies (vs "step": the engine
                    # step raises) — either way the supervisor answers
                    eng.faults.check("crash")
                eng.step()
            # harvest unconditionally: cancels/deadline expiries complete
            # tickets even on iterations where the engine had no step work
            self._harvest()

    def _restart(self, e: BaseException) -> None:
        """Supervisor restart: respawn the engine, re-queue what never
        started, fail what was in flight with ``EngineRestarted``."""
        old = self.engine
        self.restarts += 1
        waiting_ids = {id(r) for r in old.waiting}
        with self._lock:
            started = [t for t in self._live.values()
                       if not t.done.is_set()
                       and id(t.req) not in waiting_ids]
            requeue = [t for t in (self._live.get(id(r))
                                   for r in old.waiting)
                       if t is not None and not t.done.is_set()]
            for t in started:
                self._live.pop(id(t.req), None)
        for t in started:
            if t.req.error is None:     # keep an earlier typed outcome
                t.req.error = EngineRestarted(
                    f"engine restart {self.restarts} (crash: {e!r}) lost "
                    f"this request's in-flight state")
                t.req.status = "restarted"
                t.req.t_finish = time.perf_counter()
            self._fail(t, t.req.error)
        self.engine = old.respawn()
        self.generation += 1
        reg = self.engine.registry
        reg.inc("engine.restarts")
        self.engine.tracer.instant(
            "engine.restart", restarts=self.restarts, error=repr(e),
            requeued=len(requeue), failed=len(started))
        for t in requeue:       # FIFO order preserved (old.waiting order)
            try:
                self.engine.submit(t.req)   # keeps t_submit: deadlines
            except Exception as ex:         # noqa: BLE001   # still bind
                with self._lock:
                    self._live.pop(id(t.req), None)
                self._fail(t, ex)

    def _mark_crashed(self, e: BaseException) -> None:
        with self._lock:
            self.crashed = e
            for t in self._tickets.values():
                if not t.done.is_set():
                    t.error = RuntimeError(f"serve thread crashed: {e!r}")
                    if t.req.error is None:
                        t.req.error = t.error
                        t.req.status = "failed"
                    t.done.set()
            # pending call() thunks must fail too, or a caller blocked in
            # call(wait=True) — e.g. a migration extract racing the crash
            # — would wait forever on an event no thread will ever set
            calls, self._calls = self._calls, []
        for c in calls:
            c[2] = FrontendClosed(f"serve thread crashed: {e!r}")
            if c[1] is not None:
                c[1].set()
            else:
                self.callback_errors.append(f"call: dropped by crash {e!r}")

    def _harvest(self) -> None:
        """Stream new tokens out of live slots and complete tickets whose
        requests reached a terminal state — success OR a typed failure
        (cancelled / deadline / shed / isolated fault)."""
        eng = self.engine
        with self._lock:
            for s in eng.slots:
                if s is None:
                    continue
                t = self._live.get(id(s.req))
                if t is None:
                    continue
                t.version = s.version
                if len(s.out) > len(t.tokens):
                    t.tokens.extend(s.out[len(t.tokens):])
        finished = [t for t in list(self._live.values())
                    if t.req.out is not None or t.req.error is not None]
        for t in finished:
            with self._lock:
                del self._live[id(t.req)]
                if t.req.out is not None:
                    t.tokens = [int(x) for x in t.req.out]
                    t.version = t.req.out_version
                else:
                    t.error = t.req.error
            if t.req.out is not None and t.on_finish is not None:
                # success hook only: a failed request has no coherent
                # engine-side state for hooks (e.g. blocks to pin)
                try:
                    t.on_finish(t.req)
                except Exception as e:          # noqa: BLE001
                    self.callback_errors.append(
                        f"on_finish({t.handle}): {e!r}")
            t.done.set()

    def _fail(self, t: _Ticket, e: Exception) -> None:
        with self._lock:
            t.error = e
        if t.req.error is None:
            t.req.error = e
            t.req.status = t.req.status if t.req.status != "ok" \
                else "failed"
            t.req.t_finish = time.perf_counter()
        t.done.set()


class AsyncSession:
    """Multi-turn conversation through the front-end: the ``AgentSession``
    semantics (prefill only the new message, pin conversation blocks
    between turns) with non-blocking turns.

    ``send()`` submits turn N+1 as soon as turn N's reply is known
    (waiting for it if necessary, since the reply is part of the next
    prompt) and returns a handle — stream the reply with
    ``frontend.poll(handle)`` or block with ``result()``.  Pinning runs
    on the serve thread via the ``on_finish`` hook.  Across a weight
    push the pin naturally shrinks to the current-version blocks: the
    next turn re-prefills the conversation under the new weights and
    re-pins (exactly the incremental-invalidation contract)."""

    def __init__(self, frontend: AsyncFrontend, *,
                 temperature: float = 0.0):
        if frontend.engine.prefix is None:
            raise ValueError("AsyncSession needs an engine with "
                             "prefix_cache=True (and a non-hybrid family: "
                             "recurrent state cannot be re-aliased)")
        self.frontend = frontend
        self.temperature = temperature
        self.tokens: List[int] = []       # full conversation so far
        self._pinned: List[int] = []      # serve-thread-owned pin
        self._pin_gen = frontend.generation   # engine the pin lives in
        self._turn_handle: Optional[int] = None
        self._turn_prompt: Optional[List[int]] = None
        self.turns = 0
        self.last_turn: Dict[str, int] = {}
        self._closed = False

    # ----------------------------------------------------------------- api
    def send(self, user_tokens: Sequence[int], *, max_new: int = 32,
             temperature: Optional[float] = None) -> int:
        """Append ``user_tokens``; submit the turn.  Returns the handle
        (poll it for streaming; ``result()`` for the blocking reply)."""
        if self._closed:
            raise RuntimeError("session is closed")
        self._sync()                      # previous reply joins the prompt
        prompt = self.tokens + [int(t) for t in user_tokens]
        handle = self.frontend.submit(
            prompt, max_new=max_new,
            temperature=self.temperature if temperature is None
            else temperature,
            on_finish=self._pin)
        self._turn_handle, self._turn_prompt = handle, prompt
        return handle

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block for the current turn's reply."""
        req = self._sync(timeout)
        if req is None:
            raise RuntimeError("no turn in flight")
        return req.out

    def poll(self) -> PollResult:
        if self._turn_handle is None:
            raise RuntimeError("no turn in flight")
        return self.frontend.poll(self._turn_handle)

    def close(self) -> None:
        """Finish the in-flight turn (if any) and drop the pin.

        Crash-safe and idempotent: on a crashed/closed front-end (or a
        turn that failed with a typed error) this swallows the failure
        and still unwinds local state.  A pin taken against an engine
        generation that has since been respawned is simply dropped — its
        blocks died with the old device pool, so releasing them into the
        rebuilt allocator would corrupt a stranger's refcounts."""
        if self._closed:
            return
        self._closed = True
        try:
            self._sync()
        except Exception:               # noqa: BLE001 - crash-safe close
            self._turn_handle = self._turn_prompt = None
        pinned, self._pinned = self._pinned, []
        if pinned and self.frontend.crashed is None \
                and self._pin_gen == self.frontend.generation:
            release = self.frontend.engine.kv.release
            try:
                self.frontend.call(lambda: release(pinned))
            except Exception:           # noqa: BLE001 - best-effort
                pass                    # front-end died under us: blocks
                                        # die with its engine

    @property
    def pinned_blocks(self) -> int:
        return len(self._pinned)

    # ------------------------------------------------------------ internal
    def _sync(self, timeout: Optional[float] = None) -> Optional[Request]:
        if self._turn_handle is None:
            return None
        req = self.frontend.result(self._turn_handle, timeout)
        self.tokens = self._turn_prompt + [int(t) for t in req.out]
        self.turns += 1
        self.last_turn = {"prompt_tokens": len(self._turn_prompt),
                          "new_tokens": int(len(req.out)),
                          "version": int(req.out_version)}
        self.last_turn["ttft_ms"] = (req.ttft_s or 0.0) * 1e3
        self._turn_handle = self._turn_prompt = None
        return req

    def _pin(self, req: Request) -> None:
        """Serve-thread hook: swap the pin to the grown conversation.

        ``match()`` retains on our behalf; releasing the old pin after
        keeps blocks shared by both turns above zero.  Post-push, stale
        blocks are refused by match, so the pin covers only KV the next
        turn can actually alias."""
        eng = self.frontend.engine
        toks = self._turn_prompt + [int(t) for t in req.out]
        old, old_gen = self._pinned, self._pin_gen
        _, self._pinned = eng.prefix.match(toks)
        self._pin_gen = self.frontend.generation
        # an old pin from a pre-restart engine generation is dead with
        # that engine's pool: releasing its block ids into the respawned
        # allocator would hit a stranger's refcounts
        if old and old_gen == self._pin_gen:
            eng.kv.release(old)
