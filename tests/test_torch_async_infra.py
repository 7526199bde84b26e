"""PyTorch port, the async-RL host infrastructure on the CPU: the TITO
gateway, the DP router, the heartbeat monitor and the trajectory buffer
(``repro_torch.async_rl``), and ``serving.disagg.bind_dp_router``.

Mirrors ``tests/test_async_infra.py`` test for test (TITO fragment
assembly, the text round-trip's corruption, router affinity and KV reuse,
round-robin's misses, rebalancing, heartbeat eviction, the buffer's
staleness and group rules) and the ``DPRouter`` rank-health tests of
``tests/test_pd_disagg.py``.  Beside each mirror the same operations run
through the JAX package's copy of the module, and the port's results must
equal it: the router's ranks, loads and stats (its consistent hash is
md5, deterministic across processes), the tokenizer's round trips, the
buffer's stats and groups.  ``bind_dp_router`` drives the router from a
server's health signal (``DisaggServer._notify_health``).
"""
import time

import numpy as np
import pytest

from repro.async_rl import buffer as jbuffer
from repro.async_rl import router as jrouter
from repro.async_rl import tito as jtito
from repro_torch.async_rl import HeartbeatMonitor
from repro_torch.async_rl.buffer import TrajectoryBuffer
from repro_torch.async_rl.router import DPRouter, RoundRobinRouter
from repro_torch.async_rl.tito import (TitoGateway, ToyTokenizer, Trajectory,
                                       misalignment_rate, text_roundtrip)
from repro_torch.serving import DisaggServer, bind_dp_router
from repro_torch.serving.disagg import DECODE, PREFILL


def _traj(tokens, versions=(0,), reward=0.0, fail=False, cls=Trajectory):
    return cls(rollout_id="r", task="t",
               prompt=np.array([1, 2], np.int32),
               tokens=np.asarray(tokens, np.int32),
               logprobs=np.zeros(len(tokens), np.float32),
               versions=list(versions), reward=reward,
               env_failure=fail)


# ---------------------------------------------------------------------------
# mirrors of tests/test_async_infra.py
# ---------------------------------------------------------------------------

def test_tito_fragment_assembly():
    gw = TitoGateway()
    rid = gw.new_rollout("swe")
    gw.record(rid, [1, 2, 3], [-0.1, -0.2, -0.3], weight_version=0)
    gw.record(rid, [4, 5], [-0.4, -0.5], weight_version=2)
    t = gw.finish(rid, "swe", np.array([9]), reward=1.0)
    np.testing.assert_array_equal(t.tokens, [1, 2, 3, 4, 5])
    np.testing.assert_allclose(t.logprobs, [-0.1, -0.2, -0.3, -0.4, -0.5])
    assert t.versions == [0, 2] and t.version_min == 0
    assert t.tokens.dtype == np.int32 and t.logprobs.dtype == np.float32
    empty = gw.finish(gw.new_rollout("swe"), "swe", np.array([9]), 0.0)
    assert len(empty.tokens) == 0 and empty.version_min == 0


def test_text_roundtrip_corrupts_alignment():
    """The text-in-text-out baseline merges adjacent pairs -> misalignment;
    TITO by construction has zero."""
    tok = ToyTokenizer(vocab=32)
    t = _traj([4, 5, 7, 2, 10, 11])      # (4,5) and (10,11) merge
    rt = text_roundtrip(t, tok)
    assert len(rt.tokens) < len(t.tokens)
    assert misalignment_rate(t, tok) > 0
    clean = _traj([3, 5, 7, 9])          # no mergeable pairs
    assert misalignment_rate(clean, tok) == 0.0


def test_router_affinity_and_reuse():
    r = DPRouter(n_ranks=4)
    rank0 = r.route("roll-1")
    for _ in range(5):
        assert r.route("roll-1") == rank0       # stable across turns
    # growing context reuses the KV prefix
    r.request("roll-1", 100)
    inc = r.request("roll-1", 150)
    assert inc == 50
    assert r.stats["hits"] == 1


def test_round_robin_misses_kv():
    rr = RoundRobinRouter(n_ranks=4)
    dp = DPRouter(n_ranks=4)
    for rid in ("a", "b", "c", "d"):
        for turn in range(1, 5):
            rr.request(rid, 100 * turn)
            dp.request(rid, 100 * turn)
    assert dp.stats["prefill_tokens"] < rr.stats["prefill_tokens"]


def test_router_rebalance():
    r = DPRouter(n_ranks=2, rebalance_threshold=1.2)
    for i in range(64):
        r.route(f"x-{i}")
    loads = sorted(r.load.values())
    assert loads[-1] - loads[0] <= max(4, 0.3 * sum(loads) / 2)


def test_heartbeat_eviction_and_rerouting():
    mon = HeartbeatMonitor(timeout_s=0.05)
    mon.register("s0")
    mon.register("s1")
    mon.beat("s0")
    time.sleep(0.08)
    mon.beat("s1")          # s1 alive, s0 lapsed
    evicted = mon.sweep()
    assert evicted == ["s0"]
    assert mon.healthy_servers() == ["s1"]
    mon.beat("s0")          # dead servers cannot resurrect via beat
    assert not mon.is_healthy("s0")


def test_buffer_staleness_and_groups():
    buf = TrajectoryBuffer(group_size=4, staleness_tau=2)
    # stale sample dropped
    buf.add("g0", _traj([1], versions=[0]), current_version=5)
    assert buf.stats["stale_dropped"] == 1
    # group with 1 failure -> padded
    for i in range(3):
        buf.add("g1", _traj([1], versions=[5], reward=1.0), 5)
    buf.add("g1", _traj([1], versions=[5], fail=True), 5)
    assert buf.stats["groups_padded"] == 1
    g = buf.pop_groups(1)[0]
    assert len(g) == 4 and all(not t.env_failure for t in g)
    # group with majority failures -> dropped
    for i in range(3):
        buf.add("g2", _traj([1], versions=[5], fail=True), 5)
    buf.add("g2", _traj([1], versions=[5]), 5)
    assert buf.stats["groups_dropped"] == 1
    assert buf.n_ready() == 0


# ---------------------------------------------------------------------------
# mirrors of tests/test_pd_disagg.py's DPRouter rank-health tests
# ---------------------------------------------------------------------------

def test_dp_router_drop_reroutes_and_restore_readds():
    r = DPRouter(n_ranks=3, vnodes=16)
    pinned = {f"ro{i}": r.route(f"ro{i}") for i in range(30)}
    victim = max(set(pinned.values()),
                 key=lambda k: sum(v == k for v in pinned.values()))
    orphans = [rid for rid, rk in pinned.items() if rk == victim]
    r.drop_rank(victim)
    r.drop_rank(victim)                       # idempotent
    assert r.stats["dropped_ranks"] == 1
    assert r.stats["repinned_rollouts"] == len(orphans)
    assert victim not in r.healthy_ranks()
    # the dead rank's keyspace reroutes IMMEDIATELY — old pins included
    for rid in list(pinned) + [f"new{i}" for i in range(20)]:
        assert r.route(rid) != victim
    assert r.load[victim] == 0
    r.restore_rank(victim)
    assert r.healthy_ranks() == [0, 1, 2]
    assert any(r.route(f"post{i}") == victim for i in range(64))


def test_dp_router_all_dead_raises_and_rebalance_skips_dead():
    r = DPRouter(n_ranks=2, vnodes=8, rebalance_threshold=0.1)
    r.drop_rank(0)
    # rebalance target can only be the surviving rank
    assert all(r.route(f"x{i}") == 1 for i in range(16))
    r.drop_rank(1)
    with pytest.raises(RuntimeError, match="no healthy ranks"):
        r.route("anything")
    r.restore_rank(1)
    assert r.route("back") == 1


# ---------------------------------------------------------------------------
# the port against the reference's copies of the same host modules
# ---------------------------------------------------------------------------

def _router_trace(mod, seed):
    """One scripted workload: multi-turn rollouts, finishes, a rank drop
    and restore, a rebalance-happy threshold; returns everything a caller
    can observe."""
    rng = np.random.default_rng(seed)
    r = mod.DPRouter(n_ranks=4, vnodes=32, rebalance_threshold=1.3)
    rr = mod.RoundRobinRouter(n_ranks=4)
    seen = []
    for step in range(120):
        rid = f"roll-{int(rng.integers(0, 24))}"
        ctx = int(rng.integers(10, 400))
        seen.append((r.request(rid, ctx), r.route(rid), rr.request(rid, ctx)))
        if step % 17 == 5:
            r.finish(f"roll-{int(rng.integers(0, 24))}")
        if step == 60:
            r.drop_rank(int(rng.integers(0, 4)))
        if step == 90:
            for k in range(4):
                r.restore_rank(k)
    return seen, dict(r.stats), dict(r.load), dict(rr.stats), \
        r.healthy_ranks()


def test_router_equals_reference_on_a_workload():
    import repro_torch.async_rl.router as prouter
    for seed in (0, 1):
        assert _router_trace(prouter, seed) == _router_trace(jrouter, seed)


def test_tokenizer_round_trip_equals_reference():
    rng = np.random.default_rng(7)
    tok, jtok = ToyTokenizer(vocab=32), jtito.ToyTokenizer(vocab=32)
    for _ in range(40):
        toks = rng.integers(0, 32, size=int(rng.integers(0, 24)))
        t = _traj(toks)
        jt = _traj(toks, cls=jtito.Trajectory)
        assert tok.decode(toks) == jtok.decode(toks)
        np.testing.assert_array_equal(text_roundtrip(t, tok).tokens,
                                      jtito.text_roundtrip(jt, jtok).tokens)
        np.testing.assert_array_equal(
            text_roundtrip(t, tok).logprobs,
            jtito.text_roundtrip(jt, jtok).logprobs)
        assert misalignment_rate(t, tok) == jtito.misalignment_rate(jt, jtok)


def test_buffer_equals_reference_on_a_stream():
    rng = np.random.default_rng(11)
    ours = TrajectoryBuffer(group_size=4, staleness_tau=2, max_ready=5)
    ref = jbuffer.TrajectoryBuffer(group_size=4, staleness_tau=2,
                                   max_ready=5)
    popped, ref_popped = [], []
    for step in range(200):
        key = f"g{int(rng.integers(0, 12))}"
        vmin = int(rng.integers(0, 8))
        cur = int(rng.integers(vmin, vmin + 4))
        fail = bool(rng.random() < 0.3)
        reward = float(rng.random())
        ours.add(key, _traj([step], versions=[vmin], reward=reward,
                            fail=fail), cur)
        ref.add(key, _traj([step], versions=[vmin], reward=reward,
                           fail=fail, cls=jtito.Trajectory), cur)
        assert ours.has_capacity() == ref.has_capacity()
        if step % 9 == 8:
            n, at = int(rng.integers(1, 3)), int(rng.integers(0, 9))
            popped += [[int(t.tokens[0]) for t in g]
                       for g in ours.pop_groups(n, at)]
            ref_popped += [[int(t.tokens[0]) for t in g]
                           for g in ref.pop_groups(n, at)]
    assert popped == ref_popped and len(popped) > 0
    assert ours.stats == ref.stats
    assert ours.n_ready() == ref.n_ready()


# ---------------------------------------------------------------------------
# bind_dp_router: the server's health signal moves the hash ring
# ---------------------------------------------------------------------------

class _HealthOnly:
    """The part of ``DisaggServer`` the binding touches: its health
    callbacks and the error list they report into."""

    def __init__(self):
        self.health_callbacks = []
        self.callback_errors = []

    notify = DisaggServer._notify_health


def test_bind_dp_router_drops_and_restores_tier_ranks():
    srv, router = _HealthOnly(), DPRouter(n_ranks=2, vnodes=16)
    bind_dp_router(srv, router, {PREFILL: 0})
    pinned = [router.route(f"r{i}") for i in range(16)]
    assert 0 in pinned
    srv.notify(PREFILL, False)                  # the tier went down
    assert router.healthy_ranks() == [1]
    assert all(router.route(f"r{i}") == 1 for i in range(16))
    srv.notify(DECODE, False)                   # no rank bound: ignored
    assert router.healthy_ranks() == [1]
    srv.notify(PREFILL, True)                   # fail-back
    assert router.healthy_ranks() == [0, 1]
    assert router.stats["dropped_ranks"] == 1
    assert router.stats["restored_ranks"] == 1
    assert not srv.callback_errors
