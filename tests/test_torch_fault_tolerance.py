"""PyTorch port, fault-tolerant serving on the CPU: deadlines,
cancellation, shedding, serve-loop supervision and the fault injector.

Mirrors ``tests/test_fault_tolerance.py`` on the port, with the reference
tests' family configs and weights bridged from JAX
(``tests/_torch_families.py``), fp32:

* ``repro_torch.faults``: the grammar with the points the slice wires
  (``crash``, ``beat``, ``xfer``, ``route``), per-point schedules,
  ``(spec, seed)`` determinism, typed ``check``; ``worker`` stays refused
  until the orchestrator is ported;
* the scheduler: queued and mid-flight deadlines (mid-flight KV donated),
  cancellation, typed ``EngineOverloaded``, shedding on a pinned-out pool,
  the head-of-line window, alloc storms, isolated per-request faults, and
  ``respawn`` keeping the schedule and the geometry — and, the port's
  counterpart of the reference's jit-cache concerns, releasing the dead
  engine's pool first;
* front-end supervision: crash, respawn, requeue (never started) or
  ``EngineRestarted`` (in flight), the restart cap with a crash-safe
  ``AsyncSession.close``, re-waitable ``result`` timeouts and ``detach``,
  whole-``flush`` timeouts, isolated ``call`` exceptions, caller-thread
  ``EngineOverloaded``; an error of the card is not restarted;
* survivors byte-identical to the fault-free run under an isolated fault,
  for GQA, GQA + DSA, MLA and the hybrid;
* the property: refcounts and the free list conserved under random
  interleavings of submit / cancel / deadline / pressure / push / step;
* the env-spec test: zero requests lost under whatever ``REPRO_FAULTS``
  holds.

The reference's orchestrator test (the ``worker`` and ``beat`` points in
``async_rl``'s rollout workers) waits for the port of the orchestrator.
Every blocking call passes a timeout and every front-end is closed in a
``finally``; serve threads are daemon threads.
"""
import functools
import threading
import time

import numpy as np
import pytest

from _hypothesis_compat import given, settings, strategies as st
from _torch_families import family
from repro_torch.faults import FaultInjector, InjectedFault
from repro_torch.serving import (AsyncFrontend, AsyncSession, CacheFull,
                                 ContinuousEngine, DeadlineExceeded,
                                 EngineOverloaded, EngineRestarted,
                                 FrontendClosed, Request, RequestCancelled,
                                 RequestShed, ServingError)

_KW = dict(max_batch=4, block_size=8, num_blocks=64, max_len=64)
T_OUT = 60.0


def _prompts(n, seed=11, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab,
                         size=int(rng.integers(5, 12))).astype(np.int32)
            for _ in range(n)]


def _engine(name="gqa", **kw):
    _, _, model = family(name)
    return ContinuousEngine(model.cfg, model, device="cpu",
                            **dict(_KW, **kw))


def _drain(eng, max_steps=500):
    for _ in range(max_steps):
        if not eng.busy:
            return
        eng.step()
    raise AssertionError(f"engine did not drain in {max_steps} steps: "
                         f"waiting={len(eng.waiting)}")


def _pool_conserved(eng):
    """Idle-engine pool invariant: free + used == total and every block
    the radix tree holds is held exactly once."""
    kv = eng.kv
    assert kv.free_blocks + kv.used_blocks == kv.num_blocks
    if eng.prefix is not None:
        nodes = list(eng.prefix._iter_nodes())
        assert all(kv.refcount(n.block) >= 1 for n in nodes)
        assert kv.used_blocks == len({n.block for n in nodes})
    else:
        assert kv.used_blocks == 0


# ---------------------------------------------------------------------------
# fault injector: grammar, schedules, determinism
# ---------------------------------------------------------------------------

def test_injector_grammar_and_schedules():
    inj = FaultInjector("alloc@2,prefill@1..3,step~0.5,slow@0=0.05,beat,"
                        "crash@4,xfer@1=0.3,route~1")
    assert inj.enabled
    assert [inj.fires("alloc") for _ in range(5)] == [
        False, False, True, False, False]
    assert [inj.fires("prefill") for _ in range(5)] == [
        False, True, True, True, False]
    assert inj.param("slow", 0.02) == pytest.approx(0.05)
    assert inj.param("alloc", 0.02) == pytest.approx(0.02)
    assert inj.param("xfer", 0.0) == pytest.approx(0.3)
    assert all(inj.fires("beat") for _ in range(4))      # bare point: always
    assert [inj.fires("crash") for _ in range(6)] == [False] * 4 + [True,
                                                                    False]
    assert all(inj.fires("route") for _ in range(3))     # p = 1
    assert not inj.fires("worker")                       # unarmed point
    assert inj.fired["alloc"] == 1 and inj.fired["prefill"] == 3
    with pytest.raises(ValueError, match="orchestrator"):
        FaultInjector("worker@0")                        # not wired yet


def test_injector_probabilistic_determinism_and_independence():
    a = FaultInjector("step~0.3,slow~0.3", seed=7)
    b = FaultInjector("step~0.3,slow~0.3", seed=7)
    seq_a = [a.fires("step") for _ in range(64)]
    for _ in range(50):
        b.fires("slow")                  # interleave a different point
    seq_b = [b.fires("step") for _ in range(64)]
    assert seq_a == seq_b
    assert seq_a != [FaultInjector("step~0.3", seed=8).fires("step")
                     for _ in range(64)]                 # seed matters
    assert any(seq_a) and not all(seq_a)


def test_injector_check_raises_typed_and_disabled_is_free():
    inj = FaultInjector("admit@0")
    with pytest.raises(InjectedFault) as ei:
        inj.check("admit", rid=42)
    assert ei.value.point == "admit" and ei.value.rid == 42
    inj.check("admit")                   # past the schedule: no raise
    off = FaultInjector("")
    assert not off.enabled
    assert not off.fires("step")
    off.check("step")                    # disabled: never raises


# ---------------------------------------------------------------------------
# scheduler: deadlines, cancellation, backpressure, shedding, HOL window
# ---------------------------------------------------------------------------

def test_deadline_queued_and_midflight_donates():
    eng = _engine()
    prompts = _prompts(3)
    dead = Request(prompt=prompts[0], max_new=8, deadline_s=0.0)
    live = Request(prompt=prompts[1], max_new=32)
    slow = Request(prompt=prompts[2], max_new=32, deadline_s=0.05)
    for r in (dead, live, slow):
        eng.submit(r)
    eng.step()                           # queued expiry sweeps first
    assert isinstance(dead.error, DeadlineExceeded)
    assert dead.status == "deadline" and dead.out is None and dead.finished
    time.sleep(0.06)                     # slow's budget runs out mid-flight
    eng.step()
    assert isinstance(slow.error, DeadlineExceeded)
    assert slow.status == "deadline"
    assert eng.cached_blocks > 0         # mid-flight KV donated to radix
    eng.cancel(live.rid)
    _drain(eng)
    assert eng.stats["deadline_expired"] == 2
    _pool_conserved(eng)


def test_cancel_queued_midflight_and_unknown():
    eng = _engine()
    prompts = _prompts(2)
    queued = Request(prompt=prompts[0], max_new=8)
    flying = Request(prompt=prompts[1], max_new=32)
    eng.submit(flying)
    eng.step()                           # flying takes a slot
    eng.submit(queued)
    assert eng.cancel(queued.rid)        # still waiting: no engine state
    assert isinstance(queued.error, RequestCancelled)
    assert queued.status == "cancelled"
    cached_before = eng.cached_blocks
    assert eng.cancel(flying.rid)        # mid-flight: donate written KV
    assert flying.status == "cancelled"
    assert eng.cached_blocks > cached_before
    assert not eng.cancel(flying.rid)    # already terminal
    assert not eng.cancel(10_000)        # unknown rid
    assert eng.stats["cancels"] == 2
    _drain(eng)
    _pool_conserved(eng)


def test_submit_overload_typed_fast_fail():
    eng = _engine(max_waiting=2)
    prompts = _prompts(3)
    eng.submit(Request(prompt=prompts[0], max_new=4))
    eng.submit(Request(prompt=prompts[1], max_new=4))
    with pytest.raises(EngineOverloaded):
        eng.submit(Request(prompt=prompts[2], max_new=4))
    assert eng.stats["overloads"] == 1
    _drain(eng)
    _pool_conserved(eng)


def test_shed_on_pinned_pool_then_recover():
    eng = _engine(num_blocks=8)
    pins = eng.kv.alloc(8)               # a session pinned the whole pool
    reqs = [Request(prompt=p, max_new=4) for p in _prompts(3)]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    assert all(isinstance(r.error, RequestShed) for r in reqs)
    assert all(r.status == "shed" for r in reqs)
    assert eng.stats["sheds"] == 3
    eng.kv.release(pins)
    ok = Request(prompt=reqs[0].prompt, max_new=4)
    eng.submit(ok)                       # the engine survived the squeeze
    _drain(eng)
    assert ok.out is not None and ok.status == "ok"
    _pool_conserved(eng)


def test_hol_window_admits_smaller_fit_behind_stalled_head():
    eng = _engine(num_blocks=8, max_batch=2)
    pins = eng.kv.alloc(4)               # 4 blocks (32 tokens) left
    big = Request(prompt=np.arange(3, 33, dtype=np.int32) % 200 + 3,
                  max_new=8)             # needs 38 slots -> 5 blocks
    small = Request(prompt=np.asarray([5, 6, 7, 8], np.int32), max_new=4)
    eng.submit(big)
    eng.submit(small)
    eng.step()
    assert small.rid not in [r.rid for r in eng.waiting]   # skipped ahead
    assert eng.stats["admit_skips"] == 1
    assert big in eng.waiting            # head delayed, not dropped
    eng.kv.release(pins)
    _drain(eng)
    assert small.out is not None
    assert big.out is not None and big.status == "ok"
    _pool_conserved(eng)


def test_alloc_storm_on_empty_engine_sheds_typed():
    eng = _engine(faults=FaultInjector("alloc@0..2"))
    reqs = [Request(prompt=p, max_new=4) for p in _prompts(3)]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    assert all(r.finished for r in reqs)
    shed = [r for r in reqs if isinstance(r.error, RequestShed)]
    served = [r for r in reqs if r.error is None]
    assert len(shed) >= 1 and len(served) >= 1
    assert all(r.out is not None for r in served)
    assert eng.stats["sheds"] == len(shed)
    _pool_conserved(eng)


@pytest.mark.parametrize("spec,counter", [("admit@0", "request_faults"),
                                          ("prefill@0", "request_faults")])
def test_isolated_per_request_faults(spec, counter):
    eng = _engine(faults=FaultInjector(spec))
    reqs = [Request(prompt=p, max_new=4) for p in _prompts(3)]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    failed = [r for r in reqs if isinstance(r.error, InjectedFault)]
    assert len(failed) == 1 and failed[0].status == "failed"
    for r in reqs:
        if r is not failed[0]:           # the fault cost ONE request
            assert r.out is not None and r.status == "ok"
    assert eng.stats[counter] == 1
    _pool_conserved(eng)


def test_respawn_shares_schedule_and_preserves_geometry():
    faults = FaultInjector("step@2")
    eng = _engine(max_waiting=7, admit_hol_window=3, faults=faults)
    req = Request(prompt=_prompts(1)[0], max_new=6)
    eng.submit(req)
    with pytest.raises(InjectedFault):
        _drain(eng)                      # step fault is engine-level
    model = eng.params
    fresh = eng.respawn()
    assert fresh.faults is faults        # schedule does NOT re-fire
    assert fresh.registry is eng.registry
    assert fresh.params is model         # the same module: no weight copy
    assert (fresh.max_batch, fresh.block_size, fresh.kv.num_blocks,
            fresh.max_waiting, fresh.admit_hol_window, fresh.device) == (
        eng.max_batch, eng.block_size, eng.kv.num_blocks,
        eng.max_waiting, eng.admit_hol_window, eng.device)
    # the dead engine's pool and slots are released, not kept beside the
    # new pool (the torch counterpart of the reference's donated buffers)
    assert eng.pool == {} and all(s is None for s in eng.slots)
    ok = Request(prompt=req.prompt, max_new=6)
    fresh.submit(ok)
    _drain(fresh)
    assert ok.out is not None
    _pool_conserved(fresh)


def test_respawn_takes_the_push_waiting_at_the_barrier():
    eng = _engine()
    eng.submit(Request(prompt=_prompts(1)[0], max_new=6))
    eng.step()                           # in flight: the push must wait
    assert eng.push_weights(eng.params, 3) is False
    fresh = eng.respawn()
    assert fresh.weight_version == 3 and fresh.kv.version == 3


# ---------------------------------------------------------------------------
# front-end: cancellation, timeouts, supervision, crashed-close
# ---------------------------------------------------------------------------

def _gated_frontend(**kw):
    """Front-end whose serve thread is parked behind an event, so client-
    side behavior (inbox cancels, timeouts, overload) is deterministic."""
    fe = AsyncFrontend(_engine(**kw))
    gate = threading.Event()
    fe.call(lambda: gate.wait(T_OUT), wait=False)
    return fe, gate


def test_result_timeout_rewaitable_then_detach():
    fe, gate = _gated_frontend()
    try:
        prompts = _prompts(2)
        h = fe.submit(prompts[0], max_new=4)
        with pytest.raises(TimeoutError):
            fe.result(h, timeout=0.05)
        with pytest.raises(TimeoutError):
            fe.flush(timeout=0.05)       # whole-flush timeout, same deal
        gate.set()
        req = fe.result(h, timeout=T_OUT)    # the ticket stayed re-waitable
        assert req.out is not None
        h2 = fe.submit(prompts[1], max_new=4)
        fe.detach(h2)                    # abandoned without a leak
        with pytest.raises(KeyError):
            fe.poll(h2)
        fe.flush(timeout=T_OUT)
    finally:
        gate.set()
        fe.close(timeout=T_OUT)


def test_frontend_cancel_inbox_and_midflight():
    fe, gate = _gated_frontend()
    try:
        prompts = _prompts(2)
        h_inbox = fe.submit(prompts[0], max_new=4)
        assert fe.cancel(h_inbox)        # never reached the engine
        gate.set()
        with pytest.raises(RequestCancelled):
            fe.result(h_inbox, timeout=T_OUT)
        h_fly = fe.submit(prompts[1], max_new=48)
        t0 = time.time()
        while not fe.poll(h_fly).tokens.size and not fe.poll(h_fly).done:
            assert time.time() - t0 < T_OUT
            time.sleep(0.002)            # until genuinely mid-flight
        assert fe.cancel(h_fly)
        with pytest.raises(RequestCancelled):
            fe.result(h_fly, timeout=T_OUT)
        assert not fe.cancel(h_fly)      # already terminal
        assert not fe.cancel(10_000)     # unknown handle
    finally:
        gate.set()
        fe.close(timeout=T_OUT)


def test_frontend_overload_fast_fails_on_caller_thread():
    fe, gate = _gated_frontend(max_waiting=2)
    try:
        accepted, overloaded = [], 0
        for p in _prompts(5):
            try:
                accepted.append(fe.submit(p, max_new=4))
            except EngineOverloaded:
                overloaded += 1
        assert len(accepted) == 2 and overloaded == 3
        gate.set()
        for h in accepted:
            assert fe.result(h, timeout=T_OUT).out is not None
    finally:
        gate.set()
        fe.close(timeout=T_OUT)


def test_call_exceptions_isolated_from_serve_loop():
    fe = AsyncFrontend(_engine())
    try:
        with pytest.raises(ZeroDivisionError):
            fe.call(lambda: 1 / 0)
        fe.call(lambda: [][1], wait=False)
        h = fe.submit(_prompts(1)[0], max_new=4)
        assert fe.result(h, timeout=T_OUT).out is not None   # loop survived
        assert fe.crashed is None
        assert any("call:" in e for e in fe.callback_errors)
    finally:
        fe.close(timeout=T_OUT)


def test_supervisor_restart_requeues_and_serves_fresh_traffic():
    _, _, model = family("gqa")
    prompts = _prompts(4)
    oracle = ContinuousEngine(model.cfg, model, device="cpu", **_KW).serve(
        [Request(prompt=p, max_new=6) for p in prompts])
    fe = AsyncFrontend(ContinuousEngine(model.cfg, model, device="cpu",
                                        faults=FaultInjector("crash@2"),
                                        **_KW), max_restarts=2)
    try:
        first = fe.engine
        handles = [fe.submit(p, max_new=6) for p in prompts]
        outcomes = {"ok": 0, "restarted": 0}
        for idx, h in enumerate(handles):
            try:
                req = fe.result(h, timeout=T_OUT)
                outcomes["ok"] += 1      # survivor: byte-parity holds
                np.testing.assert_array_equal(req.out, oracle[idx].out)
            except EngineRestarted:
                outcomes["restarted"] += 1
        assert outcomes["ok"] + outcomes["restarted"] == len(prompts)
        assert outcomes["restarted"] >= 1
        assert fe.restarts == 1 and fe.crashed is None
        assert first.pool == {}          # the dead generation's pool freed
        assert fe.engine.params is model
        h = fe.submit(prompts[0], max_new=6)
        np.testing.assert_array_equal(fe.result(h, timeout=T_OUT).out,
                                      oracle[0].out)
        assert fe.generation == 1
        assert fe.registry.snapshot()["counters"]["engine.restarts"] == 1
    finally:
        fe.close(timeout=T_OUT)


class _LateCrash(FaultInjector):
    """Injector armed at a moment the TEST chooses: deterministic crash
    placement without counting serve-loop iterations."""

    def __init__(self):
        super().__init__("")
        self.enabled = True
        self.arm = False
        self.calls["crash"] = 1          # check() reads calls[point] - 1

    def fires(self, point):
        return self.arm and point == "crash"


def test_restart_cap_crashes_frontend_and_session_close_is_safe():
    _, _, model = family("gqa")
    inj = _LateCrash()
    fe = AsyncFrontend(ContinuousEngine(model.cfg, model, device="cpu",
                                        faults=inj, **_KW), max_restarts=0)
    try:
        sess = AsyncSession(fe)
        sess.send([5, 6, 7, 8], max_new=4)
        reply = sess.result(timeout=T_OUT)   # a healthy turn pins blocks
        assert reply is not None and sess.pinned_blocks > 0
        inj.arm = True                       # next busy iteration dies
        h = fe.submit([9, 10, 11], max_new=4)
        with pytest.raises(RuntimeError, match="serve thread crashed"):
            fe.result(h, timeout=T_OUT)
        fe._thread.join(T_OUT)               # the loop exits on the crash
        assert isinstance(fe.crashed, InjectedFault)
        with pytest.raises(FrontendClosed):
            fe.submit([1, 2, 3], max_new=2)
        sess.close()                         # MUST NOT raise on a crash
        assert sess.pinned_blocks == 0       # pin dropped, not "released"
    finally:
        fe.close(timeout=T_OUT)


def test_device_error_is_not_restarted():
    """An error of the card may poison the context for good: the
    supervisor marks the front-end crashed instead of respawning into the
    same error (a crash loop)."""
    eng = _engine()

    def broken_step():
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    eng.step = broken_step
    fe = AsyncFrontend(eng, max_restarts=3)
    try:
        h = fe.submit(_prompts(1)[0], max_new=4)
        with pytest.raises(RuntimeError, match="serve thread crashed"):
            fe.result(h, timeout=T_OUT)
        fe._thread.join(T_OUT)
        assert fe.restarts == 0 and "CUDA error" in str(fe.crashed)
    finally:
        fe.close(timeout=T_OUT)


# ---------------------------------------------------------------------------
# byte-parity of survivors vs the fault-free run, all four families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family_name", ["gqa", "dsa", "mla", "hybrid"])
def test_family_survivor_parity_under_isolated_fault(family_name):
    prompts = _prompts(3, seed=23)
    oracle = _engine(family_name).serve(
        [Request(prompt=p, max_new=4) for p in prompts])
    eng = _engine(family_name, faults=FaultInjector("prefill@1"))
    reqs = [Request(prompt=p, max_new=4) for p in prompts]
    for r in reqs:
        eng.submit(r)
    _drain(eng)
    assert all(r.finished for r in reqs)             # zero lost
    failed = [r for r in reqs if r.error is not None]
    assert len(failed) == 1 and failed[0].status == "failed"
    for o, r in zip(oracle, reqs):
        if r.error is None:              # survivors: byte-identical greedy
            np.testing.assert_array_equal(o.out, r.out)
    _pool_conserved(eng)


# ---------------------------------------------------------------------------
# property: pool integrity under random fault-path interleavings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _prop_engine():
    """One long-lived engine for every example: the checked invariants hold
    at any point of any valid op sequence, so state carries over."""
    return _engine(num_blocks=16, max_waiting=8), {"version": 0}


_OPS = st.lists(st.tuples(st.sampled_from(
    ["submit", "expired", "cancel", "push", "pin", "unpin", "step",
     "retain_dup"]),
    st.integers(min_value=0, max_value=7)), min_size=1, max_size=14)


@settings(max_examples=10, deadline=None)
@given(_OPS)
def test_property_pool_integrity_under_interleavings(ops):
    eng, state = _prop_engine()
    submitted, pins = [], []
    for op, arg in ops:
        if op in ("submit", "expired"):
            r = (Request(prompt=np.asarray([3 + arg, 4, 5, 6], np.int32),
                         max_new=2 + arg % 3) if op == "submit" else
                 Request(prompt=np.asarray([9, 9, 3 + arg], np.int32),
                         max_new=2, deadline_s=0.0))
            try:
                eng.submit(r)
                submitted.append(r)
            except EngineOverloaded:
                pass
        elif op == "cancel" and submitted:
            eng.cancel(submitted[arg % len(submitted)].rid)
        elif op == "push":
            state["version"] += 1        # monotone across examples
            eng.push_weights(eng.params, state["version"])
        elif op == "pin":                # session pressure: shed path
            try:
                pins.append(eng.kv.alloc(1 + arg % 3))
            except CacheFull:
                pass
        elif op == "unpin" and pins:
            eng.kv.release(pins.pop(arg % len(pins)))
        elif op == "retain_dup":
            # retain() rejects duplicates ATOMICALLY, refcounts untouched
            held = sorted(eng.kv._ref)
            if held:
                b = held[arg % len(held)]
                before = eng.kv.refcount(b)
                with pytest.raises(ValueError):
                    eng.kv.retain([b, b])
                assert eng.kv.refcount(b) == before
        elif op == "step" and eng.busy:
            eng.step()
    _drain(eng)
    for p in pins:
        eng.kv.release(p)
    # zero lost: every submitted request reached EXACTLY ONE terminal state
    for r in submitted:
        assert r.finished
        assert (r.out is None) != (r.error is None)
    _pool_conserved(eng)


# ---------------------------------------------------------------------------
# env-driven specs: the engine under whatever REPRO_FAULTS holds
# ---------------------------------------------------------------------------

def test_env_spec_zero_lost_under_any_fault_schedule():
    _, _, model = family("gqa")
    fe = AsyncFrontend(ContinuousEngine(model.cfg, model, device="cpu",
                                        **_KW), max_restarts=5)
    lost = 0
    try:
        handles = [fe.submit(p, max_new=5) for p in _prompts(8, seed=31)]
        fe.cancel(handles[2])
        for h in handles:
            try:
                req = fe.result(h, timeout=T_OUT)
                assert req.out is not None and req.status == "ok"
            except TimeoutError:
                lost += 1
            except (ServingError, RuntimeError) as e:
                # typed per-request outcome, an isolated injected fault, or
                # the crashed-frontend fail-fast: terminal, never a hang
                assert isinstance(e, (ServingError, InjectedFault)) or \
                    "serve thread crashed" in str(e)
        assert lost == 0, f"{lost} requests hung"
        if fe.crashed is None:
            check = []
            fe.call(lambda: check.append(
                (fe.engine.kv.free_blocks, fe.engine.kv.used_blocks,
                 fe.engine.kv.num_blocks)))
            free, used, total = check[0]
            assert free + used == total
    finally:
        fe.close(timeout=T_OUT)
