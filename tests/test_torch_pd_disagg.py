"""PyTorch port, live disaggregated prefill/decode and KV-block migration
(``serving.disagg``, ``serving.migrate``, ``serving.pd_sim``) on the CPU.

Mirrors ``tests/test_pd_disagg.py`` on the port, with the reference test's
config (Yi smoke, 2 heads of 32, vocab 256) and weights bridged from JAX
(``tests/_torch_families.py``), fp32:

* ``pd_sim``: the port's copy gives the reference's result dict for the
  same ``Workload``, ``ServingConfig`` and seed; percentile ordering,
  determinism, the zero-contention ideal, the interference direction;
* the fault grammar: malformed clauses raise a ``ValueError`` naming the
  clause; ``xfer`` / ``route`` accepted, ``points=`` extends the set;
* ``MigrationChannel``: the landed rows bit-identical to the source's,
  decode after the handoff equal to a colocated engine, version stamps
  kept, typed ``MigrationFailed`` on every failure path (no prefix, an
  ``xfer`` fault, retries spent, a stalled install past the whole-attempt
  timeout, version skew, destination pool pressure), both pools
  conserved after each; incompatible engines refused;
* ``DisaggServer`` (live threads): the routing split with tokens equal to
  a colocated engine and to JAX's engine (where the top-2 margin is at
  least 1e-4), ``xfer`` faults falling back with zero lost, the ``route``
  hedge, a prefill-tier crash: degraded, respawned, failed back, health
  callbacks told and a ``DPRouter`` bound by ``bind_dp_router`` dropping
  and restoring the tier's rank, zero lost;
* the property: refcounts conserved in BOTH pools under random prefill /
  migrate / fault / skew / pin interleavings.

The reference's ``DPRouter`` rank-health tests are mirrored in
``tests/test_torch_async_infra.py``.  Every blocking call passes a timeout
and every server is closed in a ``finally``.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import time

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from _torch_families import assert_tokens_match, family
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import pd_sim as ref_sim
from repro_torch.async_rl.router import DPRouter
from repro_torch.faults import FaultInjector
from repro_torch.serving import (CacheFull, ContinuousEngine, DisaggServer,
                                 MigrationChannel, MigrationFailed, Request,
                                 bind_dp_router)
from repro_torch.serving.disagg import PREFILL
from repro_torch.serving.pd_sim import ServingConfig, Workload, simulate
from repro_torch.serving.spill import pool_leaves

_KW = dict(max_batch=4, block_size=8, num_blocks=64, max_len=128,
           device="cpu")
_PD = 32                                  # pd threshold for server tests
T_OUT = 60.0


def _model():
    return family("gqa")[2]


def _engine(**kw):
    model = _model()
    return ContinuousEngine(model.cfg, model, faults=FaultInjector(""),
                            **dict(_KW, **kw))


def _prompt(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(3, 256, size=n).tolist()


def _prefill(eng, tokens):
    """Drive one prompt through the engine's normal serve path (prefill +
    radix insert on finish); the single greedy token is discarded."""
    r = Request(prompt=np.asarray(tokens, np.int32), max_new=1)
    eng.serve([r])
    assert r.error is None, r.error


def _pool_conserved(eng):
    kv = eng.kv
    assert kv.free_blocks + kv.used_blocks == kv.num_blocks
    nodes = list(eng.prefix._iter_nodes())
    assert all(kv.refcount(n.block) >= 1 for n in nodes)
    assert kv.used_blocks == len({n.block for n in nodes})


def _wait(pred, timeout_s, what):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _rows(eng, blocks):
    stride = eng.kv.num_blocks + 1
    out = []
    for leaf in pool_leaves(eng.pool):
        L = leaf.shape[0] // stride
        idx = (torch.arange(L)[:, None] * stride
               + torch.tensor(blocks)[None, :]).reshape(-1)
        out.append(leaf[idx].contiguous().view(torch.uint8))
    return out


# ---------------------------------------------------------------------------
# pd_sim: the analytical model, against the reference's copy
# ---------------------------------------------------------------------------

_SIM_W = Workload(n_rollouts=64, turns=4, prefill_tokens_per_turn=131072,
                  decode_tokens_mean=256, decode_tokens_tail=2048,
                  tail_frac=0.15)


@pytest.mark.parametrize("cfg", [
    dict(pd_disaggregated=False),
    dict(pd_disaggregated=True, prefill_frac=0.34),
    dict(pd_disaggregated=False, continuous_batching=False, decode_batch=4,
         accept_length=2.5, dtype_speed=1.6),
])
def test_sim_equals_reference(cfg):
    for seed in (0, 3):
        got = simulate(_SIM_W, ServingConfig(**cfg), seed=seed)
        want = ref_sim.simulate(
            ref_sim.Workload(**dataclasses.asdict(_SIM_W)),
            ref_sim.ServingConfig(**cfg), seed=seed)
        assert got == want


def test_sim_percentile_ordering_and_determinism():
    m = simulate(_SIM_W, ServingConfig(pd_disaggregated=False), seed=3)
    assert m["p50_s"] <= m["p95_s"] <= m["p99_s"] <= m["max_s"]
    assert 0 < m["mean_s"] <= m["max_s"]
    assert m["mean_slowdown"] >= 1.0
    assert m == simulate(_SIM_W, ServingConfig(pd_disaggregated=False),
                         seed=3)


def test_sim_zero_contention_is_ideal():
    w = Workload(n_rollouts=1, turns=3)
    m = simulate(w, ServingConfig(pd_disaggregated=True), seed=5)
    assert m["mean_slowdown"] == pytest.approx(1.0)
    assert m["p99_slowdown"] == pytest.approx(1.0)
    mc = simulate(w, ServingConfig(pd_disaggregated=False), seed=5)
    assert mc["mean_slowdown"] > 1.0


def test_sim_interference_direction_matches_live_contract():
    co = simulate(_SIM_W, ServingConfig(pd_disaggregated=False), seed=0)
    pd = simulate(_SIM_W, ServingConfig(pd_disaggregated=True,
                                        prefill_frac=0.34), seed=0)
    assert pd["p99_slowdown"] <= co["p99_slowdown"]
    assert pd["p99_s"] <= co["p99_s"]
    one = dataclasses.replace(_SIM_W, n_rollouts=1)
    light = dataclasses.replace(one, prefill_tokens_per_turn=1024)
    co_one = simulate(one, ServingConfig(pd_disaggregated=False), seed=0)
    co_light = simulate(light, ServingConfig(pd_disaggregated=False), seed=0)
    assert co_light["mean_slowdown"] < co_one["mean_slowdown"]


# ---------------------------------------------------------------------------
# fault-spec grammar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "bogus@1", "@1", "xfer@3..1", "xfer@-1", "xfer@1..x", "xfer~1.5",
    "xfer~nope", "xfer@1@2", "slow@0=abc",
])
def test_fault_grammar_rejects_bad_clause_naming_it(spec):
    bad = spec.split(",")[-1]
    with pytest.raises(ValueError, match=re.escape(repr(bad))):
        FaultInjector(spec)
    with pytest.raises(ValueError, match=re.escape(repr(bad))):
        FaultInjector("alloc@1," + spec)


def test_fault_grammar_accepts_new_points_and_extension():
    inj = FaultInjector("xfer@1,route~0.5,xfer@3..4=0.01", seed=1)
    assert inj.armed("xfer") and inj.armed("route")
    assert inj.param("xfer", 0.0) == pytest.approx(0.01)
    custom = FaultInjector("warp@0", points=frozenset({"warp"}))
    assert custom.fires("warp")
    with pytest.raises(ValueError, match="alloc"):
        FaultInjector("alloc@0", points=frozenset({"warp"}))


# ---------------------------------------------------------------------------
# MigrationChannel
# ---------------------------------------------------------------------------

def test_migrate_handoff_byte_parity_version_and_reuse():
    src, dst, oracle = _engine(), _engine(), _engine()
    tokens = _prompt(2, 37)
    _prefill(src, tokens)
    ch = MigrationChannel(src, dst, faults=FaultInjector(""))
    payload = ch.extract(tokens)             # net-zero on src
    assert payload.ready is None             # CPU copies: done on return
    _pool_conserved(src)
    m, sblocks = src.prefix.match(tokens)
    src_rows = _rows(src, sblocks)
    src.kv.release(sblocks)
    blocks = ch.migrate(tokens)
    assert len(blocks) == (37 + 7) // 8 == payload.n_blocks
    assert set(blocks) == ch.recent_migrated_blocks()
    for a, b in zip(_rows(dst, blocks), src_rows):   # bit for bit
        assert torch.equal(a, b)
    assert all(dst.kv.block_version(b) == src.kv.version for b in blocks)
    _pool_conserved(src)
    _pool_conserved(dst)
    r = Request(prompt=np.asarray(tokens, np.int32), max_new=8)
    ro = Request(prompt=np.asarray(tokens, np.int32), max_new=8)
    dst.serve([r])
    oracle.serve([ro])
    np.testing.assert_array_equal(r.out, ro.out)
    assert dst.stats["cached_tokens"] > 0
    assert ch.registry.summary("disagg.migrate_ms")["count"] == 1
    assert ch.registry.counter("disagg.migrated_blocks") == len(blocks)


def test_migrate_failure_paths_typed_and_conserved():
    src, dst = _engine(), _engine()
    tokens = _prompt(3, 24)
    _prefill(src, tokens)

    # (1) no cached prefix: typed failure, nothing allocated anywhere
    ch = MigrationChannel(src, dst, max_retries=0, faults=FaultInjector(""))
    with pytest.raises(MigrationFailed, match="no cached prefix"):
        ch.migrate(_prompt(99, 16))
    _pool_conserved(src)
    _pool_conserved(dst)

    # (2) injected xfer fault on attempt 0, the retry succeeds
    ch = MigrationChannel(src, dst, max_retries=2, backoff_s=0.0,
                          faults=FaultInjector("xfer@0"))
    assert ch.migrate(tokens)
    assert ch.registry.counter("disagg.migration_retries") == 1
    assert ch.registry.counter("disagg.migrations") == 1
    _pool_conserved(src)
    _pool_conserved(dst)

    # (3) retry budget exhausted: typed failure, counted, conserved
    ch = MigrationChannel(src, dst, max_retries=1, backoff_s=0.0,
                          faults=FaultInjector("xfer@0..9"))
    with pytest.raises(MigrationFailed, match="2 attempts"):
        ch.migrate(tokens)
    assert ch.registry.counter("disagg.migration_failures") == 1
    _pool_conserved(src)
    _pool_conserved(dst)

    # (4) a stalled transfer (=x param) trips the per-attempt timeout
    ch = MigrationChannel(src, dst, max_retries=0, timeout_s=0.001,
                          backoff_s=0.0,
                          faults=FaultInjector("xfer@0=0.02"))
    with pytest.raises(MigrationFailed):
        ch.migrate(tokens)
    _pool_conserved(src)
    _pool_conserved(dst)


def test_migrate_whole_attempt_timeout_covers_stalled_install():
    src, dst = _engine(), _engine()
    tokens = _prompt(11, 24)
    _prefill(src, tokens)
    MigrationChannel(src, dst, max_retries=0,
                     faults=FaultInjector("")).migrate(tokens)
    ch = MigrationChannel(src, dst, max_retries=0, timeout_s=0.25,
                          backoff_s=0.0,
                          faults=FaultInjector("xfer@0=0.6"))
    with pytest.raises(MigrationFailed, match="stalled install"):
        ch.migrate(tokens)
    assert ch.registry.counter("disagg.migration_failures") == 1
    _pool_conserved(src)
    _pool_conserved(dst)
    ch2 = MigrationChannel(src, dst, max_retries=0,
                           faults=FaultInjector(""))
    assert ch2.migrate(tokens)
    _pool_conserved(src)
    _pool_conserved(dst)


def test_migrate_version_skew_refused_both_directions():
    src, dst = _engine(), _engine()
    tokens = _prompt(5, 40)
    _prefill(src, tokens)
    dst.push_weights(dst.params, 1)
    ch = MigrationChannel(src, dst, max_retries=1, backoff_s=0.0,
                          faults=FaultInjector(""))
    used_before = dst.kv.used_blocks
    with pytest.raises(MigrationFailed, match="version skew"):
        ch.migrate(tokens)
    assert dst.kv.used_blocks == used_before    # nothing landed
    _pool_conserved(src)
    _pool_conserved(dst)
    src.push_weights(src.params, 1)
    _prefill(src, tokens)                       # re-derive fresh KV
    blocks = ch.migrate(tokens)
    assert all(dst.kv.block_version(b) == 1 for b in blocks)
    _pool_conserved(src)
    _pool_conserved(dst)


def test_migrate_destination_pool_pressure():
    src, dst = _engine(), _engine(num_blocks=8)
    tokens = _prompt(7, 48)                     # needs 6 landing blocks
    _prefill(src, tokens)
    pins = dst.kv.alloc(6)                      # squeeze the free list
    ch = MigrationChannel(src, dst, max_retries=0, faults=FaultInjector(""))
    with pytest.raises(MigrationFailed, match="cannot land"):
        ch.migrate(tokens)
    assert dst.kv.free_blocks + dst.kv.used_blocks == dst.kv.num_blocks
    dst.kv.release(pins)
    assert ch.migrate(tokens)                   # pressure cleared: lands
    _pool_conserved(src)
    _pool_conserved(dst)


def test_migrate_requires_compatible_engines():
    src = _engine()
    with pytest.raises(ValueError, match="block_size"):
        MigrationChannel(src, _engine(block_size=16, num_blocks=32))
    with pytest.raises(ValueError, match="prefix_cache"):
        MigrationChannel(src, _engine(prefix_cache=False))
    mla = family("mla")[2]
    with pytest.raises(ValueError, match="pool structure"):
        MigrationChannel(src, ContinuousEngine(mla.cfg, mla, **_KW))


# ---------------------------------------------------------------------------
# DisaggServer end to end (live threads)
# ---------------------------------------------------------------------------

def _mixed(seed):
    return [_prompt(seed, 44), _prompt(seed + 1, 10),
            _prompt(seed + 2, 52), _prompt(seed + 3, 8)]


def _oracle_outs(prompts, max_new):
    eng = _engine()
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new=max_new)
            for p in prompts]
    eng.serve(reqs)
    return [list(r.out) for r in reqs]


def _server(**kw):
    model = _model()
    kw.setdefault("faults", FaultInjector(""))
    kw.setdefault("prefill_faults", FaultInjector(""))
    kw.setdefault("heartbeat_timeout_s", 30.0)
    return DisaggServer(model.cfg, model, decode_kw=dict(_KW),
                        pd_threshold=_PD, **kw)


def test_disagg_routing_split_and_oracle_parity():
    jcfg, params, model = family("gqa")
    prompts = _mixed(11)
    oracle = _oracle_outs(prompts, 4)
    srv = _server()
    try:
        # one nn.Module behind both tiers: no copy of the weights
        assert srv.prefill_frontend.engine.params is model
        assert srv.decode_frontend.engine.params is model
        hs = [srv.submit(p, max_new=4) for p in prompts]
        outs = [list(srv.result(h, timeout=T_OUT).out) for h in hs]
        assert outs == oracle               # byte parity on every path
        assert srv.stats["pd_routes"] == 2       # the two long prompts
        assert srv.stats["colocated_routes"] == 2
        assert srv.stats["migrations"] >= 1
        assert srv.stats["migrated_tokens"] > 0
        assert srv.registry.summary("disagg.migrate_ms")["count"] >= 1
        assert srv.registry.summary("disagg.migrate_bytes")["count"] >= 1
    finally:
        srv.close(timeout=T_OUT)
    jeng = JaxEngine(jcfg, params, **{k: v for k, v in _KW.items()
                                      if k != "device"})
    jreqs = [JaxRequest(prompt=np.asarray(p, np.int32), max_new=4)
             for p in prompts]
    jeng.serve(jreqs)
    assert_tokens_match(model, [np.asarray(p) for p in prompts], outs,
                        [np.asarray(r.out) for r in jreqs])


def test_disagg_migration_faults_fall_back_zero_lost():
    prompts = [_prompt(21, 44), _prompt(22, 52)]
    oracle = _oracle_outs(prompts, 4)
    srv = _server(migrate_retries=0, faults=FaultInjector("xfer"))
    try:
        hs = [srv.submit(p, max_new=4) for p in prompts]
        outs = [list(srv.result(h, timeout=T_OUT).out) for h in hs]
        assert outs == oracle               # fallback is slower, not wrong
        assert srv.stats["colocated_fallbacks"] == 2
        assert srv.stats["migration_failures"] == 2
        assert srv.stats["migrations"] == 0
    finally:
        srv.close(timeout=T_OUT)


def test_disagg_route_fault_hedges_to_colocated():
    p = _prompt(31, 44)
    srv = _server(faults=FaultInjector("route"))
    try:
        out = list(srv.result(srv.submit(p, max_new=4), timeout=T_OUT).out)
        assert out == _oracle_outs([p], 4)[0]
        assert srv.stats["route_faults"] == 1
        assert srv.stats["pd_routes"] == 0
        assert srv.stats["colocated_routes"] == 1
    finally:
        srv.close(timeout=T_OUT)


def test_disagg_prefill_crash_degrades_respawns_fails_back():
    prompts = [_prompt(41 + i, 44 + 8 * (i % 3)) for i in range(4)]
    oracle = _oracle_outs(prompts, 4)
    health = []
    srv = _server(respawn_delay_s=0.02, heartbeat_timeout_s=0.5,
                  prefill_faults=FaultInjector("crash@0"),
                  health_callbacks=[lambda t, ok: health.append((t, ok))])
    router = DPRouter(n_ranks=2)
    bind_dp_router(srv, router, {PREFILL: 0})
    try:
        first = srv.prefill_frontend.engine
        hs = [srv.submit(p, max_new=4) for p in prompts]
        outs = [list(srv.result(h, timeout=T_OUT).out) for h in hs]
        assert outs == oracle               # zero lost through the outage
        _wait(lambda: srv.stats["prefill_respawns"] >= 1
              and not srv.degraded, 30, "respawn + fail-back")
        assert srv.stats["tier_down_events"] >= 1
        assert srv.stats["failbacks"] >= 1
        assert srv.stats["colocated_fallbacks"] >= 1
        assert srv.prefill_healthy
        assert first.pool == {}             # the crashed tier's pool freed
        assert srv.channel.src is srv.prefill_frontend.engine
        # the health signal a DP router binds to saw both transitions
        assert (PREFILL, False) in health and (PREFILL, True) in health
        # the DP hash ring saw the same transitions
        assert router.stats["dropped_ranks"] >= 1
        assert router.stats["restored_ranks"] >= 1
        assert router.healthy_ranks() == [0, 1]
        assert not srv.callback_errors
        # after fail-back the split works again (migration runs)
        mig0 = srv.stats["migrations"]
        p = _prompt(51, 48)
        out = list(srv.result(srv.submit(p, max_new=4), timeout=T_OUT).out)
        assert out == _oracle_outs([p], 4)[0]
        assert srv.stats["migrations"] > mig0
    finally:
        srv.close(timeout=T_OUT)


def test_launch_counter_exact_under_threads():
    """The two tiers' serve threads count launches on the same wrappers:
    no increment may be lost (``+= 1`` on an attribute is a read and a
    write the interpreter may split between threads)."""
    import sys
    import threading
    from repro_torch.kernels.build import count_launch

    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 16, 2000

    def work():
        for _ in range(n_each):
            count_launch(wrapper)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, daemon=True)
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(T_OUT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_each


# ---------------------------------------------------------------------------
# property: refcount conservation across BOTH pools under interleavings
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _prop_pair():
    """One long-lived engine pair and channel for every example: both pools
    conserved holds at any point of any op sequence."""
    src = _engine(num_blocks=24)
    dst = _engine(num_blocks=24)
    ch = MigrationChannel(src, dst, max_retries=1, backoff_s=0.0,
                          faults=FaultInjector("xfer~0.3", seed=3))
    return src, dst, ch, {"vs": 0, "vd": 0, "prompts": []}


_PROP_OPS = st.lists(st.tuples(st.sampled_from(
    ["prefill", "migrate", "migrate_unknown", "skew_src", "skew_dst",
     "converge", "pin", "unpin"]),
    st.integers(min_value=0, max_value=7)), min_size=1, max_size=12)


@settings(max_examples=8, deadline=None)
@given(_PROP_OPS)
def test_property_migration_pool_integrity(ops):
    src, dst, ch, state = _prop_pair()
    pins = []
    for op, arg in ops:
        if op == "prefill":
            tokens = _prompt(arg, 16 + 8 * (arg % 3))
            try:
                _prefill(src, tokens)
                state["prompts"].append(tokens)
            except AssertionError:
                pass                       # shed under pool pressure: fine
        elif op == "migrate" and state["prompts"]:
            try:
                ch.migrate(state["prompts"][arg % len(state["prompts"])])
            except MigrationFailed:
                pass                       # injected fault / skew / pressure
        elif op == "migrate_unknown":
            with pytest.raises(MigrationFailed):
                ch.migrate([200 + arg] * 12)
        elif op == "skew_src":
            state["vs"] += 1
            src.push_weights(src.params, state["vs"])
            state["prompts"].clear()       # stale KV: never matched again
        elif op == "skew_dst":
            state["vd"] += 1
            dst.push_weights(dst.params, state["vd"])
        elif op == "converge":
            v = max(state["vs"], state["vd"])
            if state["vs"] < v:
                src.push_weights(src.params, v)
                state["vs"] = v
                state["prompts"].clear()
            if state["vd"] < v:
                dst.push_weights(dst.params, v)
                state["vd"] = v
        elif op == "pin":
            try:
                pins.append(dst.kv.alloc(1 + arg % 4))
            except CacheFull:
                pass
        elif op == "unpin" and pins:
            dst.kv.release(pins.pop(arg % len(pins)))
    for p in pins:
        dst.kv.release(p)
    _pool_conserved(src)
    _pool_conserved(dst)
