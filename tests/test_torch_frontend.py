"""PyTorch port, the async front-end and agent sessions
(``serving.frontend``, ``serving.session``) on the CPU.

Mirrors the front-end half of ``tests/test_async_frontend.py``, the agent
session tests of ``tests/test_prefix_cache.py`` and the session test of
``tests/test_speculative.py`` on the port, with the reference tests'
family configs and weights bridged from JAX (``tests/_torch_families.py``),
fp32:

* ``AsyncFrontend`` tokens with speculation (spec 2) and a radix hit equal
  the port's blocking ``serve()`` and JAX's ``ContinuousEngine`` (where the
  top-2 margin is at least 1e-4), for GQA, GQA + DSA and MLA;
* ``poll`` streams a monotonic prefix; impossible requests fail on the
  caller's thread; a closed front-end refuses work;
* ``push_weights`` mid-run: a request admitted before the push drains at
  its admitted version with the old weights' tokens, later ones take the
  new weights' tokens, the cache survives the push (stale blocks refused,
  then refreshed in place, refcounts conserved); ``AsyncSession`` across
  a push;
* version stamps at the allocator / radix layer; ``step_token_budget``
  defers admissions without changing outputs; the heartbeat monitor's
  deregistration and its ``beat`` fault point;
* ``AgentSession``: turn tokens equal the cache-off oracle's and JAX's
  session's, history reused, pins surviving eviction pressure, and spec
  on / off turns byte-identical.

Left out, as not yet ported: the reference's ``true_logprobs`` tests
(logprob capture) and its ``async_rl`` rollout / orchestrator tests.
Every blocking call passes a timeout and every front-end is closed in a
``finally``.
"""
import functools
import time

import numpy as np
import pytest
import torch

from _torch_families import assert_tokens_match, family, margin_ok
from repro.serving import AgentSession as JaxSession
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.async_rl import HeartbeatMonitor
from repro_torch.faults import FaultInjector
from repro_torch.models import get_model
from repro_torch.serving import (AgentSession, AsyncFrontend, AsyncSession,
                                 ContinuousEngine, FrontendClosed,
                                 PagedKVCache, PrefixCache, Request,
                                 RequestShed)

_KW = dict(max_batch=4, block_size=8, num_blocks=64, max_len=64)
T_OUT = 60.0


def _engine(model, **kw):
    return ContinuousEngine(model.cfg, model, device="cpu",
                            **dict(_KW, **kw))


def _workload(vocab):
    """3 prompts sharing one block-aligned system prefix + 1 extension of
    the first prompt (radix hit, possibly mid-block COW)."""
    rng = np.random.default_rng(5)
    sys_p = rng.integers(3, vocab, size=8)
    base = [np.concatenate([sys_p, rng.integers(3, vocab, size=k)])
            .astype(np.int32) for k in (3, 5, 9)]
    ext = np.concatenate([base[0], [7, 9, 11]]).astype(np.int32)
    return base + [ext]


def _serve_blocking(model, **kw):
    """Blocking oracle in two waves, so the extension hits the cache the
    first wave left."""
    eng = _engine(model, **kw)
    reqs = [Request(prompt=p, max_new=6) for p in _workload(256)]
    eng.serve(reqs[:3])
    eng.serve(reqs[3:])
    return [r.out for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _oracle(name):
    _, _, model = family(name, mtp=True)
    outs, eng = _serve_blocking(model)
    assert eng.stats["cached_tokens"] > 0          # the hit actually hit
    return outs


@functools.lru_cache(maxsize=None)
def _jax_oracle(name):
    jcfg, params, _ = family(name, mtp=True)
    eng = JaxEngine(jcfg, params, **_KW)
    reqs = [JaxRequest(prompt=p, max_new=6) for p in _workload(256)]
    eng.serve(reqs[:3])
    eng.serve(reqs[3:])
    return [np.asarray(r.out) for r in reqs]


def _await(pred, what, deadline_s=T_OUT):
    t0 = time.time()
    while not pred():
        if time.time() - t0 > deadline_s:
            raise TimeoutError(what)
        time.sleep(0.002)


def _await_admitted(fe, handles):
    """Each handle streamed >= 1 token: admitted at the current version."""
    _await(lambda: all(p.done or len(p.tokens) > 0
                       for p in (fe.poll(h) for h in handles)),
           "requests never admitted")


def _await_version(fe, version):
    _await(lambda: fe.version >= version, f"push to v{version} never "
                                          f"applied")


# ---------------------------------------------------------------------------
# front-end parity: the port's blocking serve and JAX's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family_name", ["gqa", "dsa", "mla"])
def test_frontend_parity_with_spec_and_cache_hits(family_name):
    _, _, model = family(family_name, mtp=True)
    fe = AsyncFrontend(_engine(model, spec_steps=2))
    try:
        prompts = _workload(256)
        hs = [fe.submit(p, max_new=6) for p in prompts[:3]]
        fe.flush(timeout=T_OUT)         # wave 2 must see wave 1's cache
        hs.append(fe.submit(prompts[3], max_new=6))
        outs = [fe.result(h, timeout=T_OUT).out for h in hs]
        for a, b in zip(_oracle(family_name), outs):
            np.testing.assert_array_equal(a, b)
        stats = fe.stats
        assert stats["spec_rounds"] > 0             # speculation ran
        assert stats["cached_tokens"] > 0           # the radix hit hit
    finally:
        fe.close(timeout=T_OUT)
    assert_tokens_match(model, prompts, outs, _jax_oracle(family_name))


def test_frontend_poll_streams_monotonic_prefix():
    _, _, model = family("gqa", mtp=True)
    fe = AsyncFrontend(_engine(model))
    try:
        h = fe.submit(_workload(256)[2], max_new=6)
        seen = []
        t0 = time.time()
        while True:
            p = fe.poll(h)
            assert list(p.tokens[:len(seen)]) == seen   # prefix-stable
            seen = list(p.tokens)
            if p.done:
                break
            assert time.time() - t0 < T_OUT
            time.sleep(0.002)
        req = fe.result(h, timeout=T_OUT)
        assert seen == list(req.out) and req.out_version == 0
        assert req.out_logprobs is None     # logprob capture: not ported
        # caller-side fail-fast: an impossible request never reaches the
        # serve thread
        with pytest.raises(ValueError):
            fe.submit(np.zeros(2 * _KW["max_len"], np.int32), max_new=4)
    finally:
        fe.close(timeout=T_OUT)
    assert not fe._thread.is_alive()
    with pytest.raises(FrontendClosed):
        fe.submit([1, 2, 3], max_new=2)


# ---------------------------------------------------------------------------
# weight pushes through the front-end
# ---------------------------------------------------------------------------

def test_push_mid_run_versions_and_cache_survival():
    _, _, model_a = family("gqa", mtp=True)
    model_b = get_model(model_a.cfg).init(
        model_a.cfg, torch.Generator().manual_seed(7), device="cpu",
        dtype=torch.float32)
    prompts = _workload(256)
    oracle_a = _oracle("gqa")
    outs_b, _ = _serve_blocking(model_b)        # the new weights' oracle

    fe = AsyncFrontend(_engine(model_a, weight_version=0))
    try:
        hs = [fe.submit(p, max_new=6) for p in prompts[:3]]
        r1 = [fe.result(h, timeout=T_OUT) for h in hs]
        assert all(r.out_version == 0 for r in r1)

        # wave 2 admitted at v0; the push lands while it is in flight and
        # the drain barrier finishes it under the admitted weights
        hs = [fe.submit(p, max_new=6) for p in prompts[:3]]
        _await_admitted(fe, hs)
        fe.push_weights(model_b, 1)
        r2 = [fe.result(h, timeout=T_OUT) for h in hs]
        assert all(r.out_version == 0 for r in r2)
        for a, r in zip(oracle_a, r2):
            np.testing.assert_array_equal(a, r.out)   # the old weights
        _await_version(fe, 1)

        # the push did NOT reset the cache: v0 blocks still cached (stale)
        snap = {}
        fe.call(lambda: snap.update(
            cached=fe.engine.prefix.cached_blocks,
            stale=fe.engine.stale_cached_blocks))
        assert snap["cached"] > 0 and snap["stale"] > 0

        hs = [fe.submit(p, max_new=6) for p in prompts[:3]]
        hs.append(fe.submit(prompts[3], max_new=6))
        r3 = [fe.result(h, timeout=T_OUT) for h in hs]
        assert all(r.out_version == 1 for r in r3)
        for b, r in zip(outs_b, r3):
            np.testing.assert_array_equal(b, r.out)   # the new weights
        assert fe.stats["weight_pushes"] == 1
        pstats, kvstate = {}, {}
        fe.call(lambda: (pstats.update(fe.engine.prefix.stats),
                         kvstate.update(
                             free=fe.engine.kv.free_blocks,
                             used=fe.engine.kv.used_blocks,
                             total=fe.engine.kv.num_blocks,
                             refs=[fe.engine.kv.refcount(n.block) for n in
                                   fe.engine.prefix._iter_nodes()])))
        assert pstats["version_refused"] > 0
        assert pstats["refreshed_blocks"] > 0
        assert kvstate["free"] + kvstate["used"] == kvstate["total"]
        assert all(r == 1 for r in kvstate["refs"])
        assert fe.engine.params is model_b      # the module, not a copy
    finally:
        fe.close(timeout=T_OUT)


def test_async_session_across_push():
    _, _, model = family("gqa", mtp=True)
    msgs = [np.asarray(m, np.int32) for m in
            ([5, 6, 7, 8, 9], [10, 11, 12], [13, 14, 15, 16])]
    sess_o = AgentSession(_engine(model))
    oracle = [sess_o.send(m, max_new=4) for m in msgs]
    sess_o.close()

    fe = AsyncFrontend(_engine(model))
    try:
        sess = AsyncSession(fe)
        replies = [None] * len(msgs)
        sess.send(msgs[0], max_new=4)
        replies[0] = sess.result(timeout=T_OUT)
        assert sess.last_turn["version"] == 0
        assert sess.pinned_blocks > 0               # conversation pinned
        # the same weights under a bumped version: the session re-prefills
        # under v1 and keeps producing the oracle's replies
        fe.push_weights(model, 1)
        _await_version(fe, 1)
        for i in (1, 2):
            sess.send(msgs[i], max_new=4)
            replies[i] = sess.result(timeout=T_OUT)
        assert sess.last_turn["version"] == 1
        for a, b in zip(oracle, replies):
            np.testing.assert_array_equal(a, b)
        sess.close()
        assert sess.pinned_blocks == 0
    finally:
        fe.close(timeout=T_OUT)


# ---------------------------------------------------------------------------
# version-tag invariants at the allocator / radix layer (no model)
# ---------------------------------------------------------------------------

def test_block_version_stamps_and_match_refusal():
    kv = PagedKVCache(num_blocks=16, block_size=4)
    cache = PrefixCache(kv)
    toks = [1, 2, 3, 4, 5, 6, 7, 8]
    cache.insert(toks, kv.alloc(2))
    assert all(kv.block_version(n.block) == 0
               for n in cache._iter_nodes())
    m, bs = cache.match(toks)
    assert m == 8
    kv.release(bs)
    kv.set_version(1)                    # the push
    assert kv.stale_blocks() == 2 and cache.stale_cached_blocks == 2
    m, bs = cache.match(toks)            # v0 KV never aliased at v1
    assert m == 0 and bs == []
    assert cache.stats["version_refused"] == 1
    m, bs = cache.match([1, 2, 3, 9])    # partial overlap refuses too
    assert m == 0 and bs == []
    with pytest.raises(ValueError):      # versions are monotone
        kv.set_version(0)


def test_insert_refreshes_stale_nodes_in_place():
    kv = PagedKVCache(num_blocks=16, block_size=4)
    cache = PrefixCache(kv)
    toks = [1, 2, 3, 4, 5, 6]
    cache.insert(toks, kv.alloc(2))
    kv.set_version(2)
    fresh = kv.alloc(2)
    cache.insert(toks, fresh)
    assert cache.stats["refreshed_blocks"] == 2
    assert cache.cached_blocks == 2 and cache.stale_cached_blocks == 0
    assert kv.stale_blocks() == 0
    m, bs = cache.match(toks)
    assert m == 6 and bs == fresh
    kv.release(bs)
    assert kv.used_blocks == 2 and kv.free_blocks == 14
    assert all(kv.refcount(b) == 1 for b in fresh)


def test_evict_takes_stale_leaves_first():
    kv = PagedKVCache(num_blocks=16, block_size=4)
    cache = PrefixCache(kv)
    cache.insert([1, 2, 3, 4], kv.alloc(1))        # will go stale
    kv.set_version(1)
    cache.insert([9, 9, 9, 9], kv.alloc(1))        # fresh, older stamp
    cache.insert([8, 8, 8, 8], kv.alloc(1))        # fresh, newest stamp
    assert cache.evict(1) == 1
    assert cache.stats["stale_evictions"] == 1     # stale went first...
    assert cache.stale_cached_blocks == 0
    assert cache.evict(1) == 1                     # ...then LRU: [9,...]
    assert cache.stats["stale_evictions"] == 1
    m, bs = cache.match([8, 8, 8, 8])
    assert m == 4
    kv.release(bs)


def test_step_token_budget_defers_without_changing_outputs():
    _, _, model = family("gqa", mtp=True)
    outs, eng = _serve_blocking(model, spec_steps=3, max_batch=2,
                                step_token_budget=5)
    assert eng.stats["budget_deferrals"] > 0
    for a, b in zip(_oracle("gqa"), outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------

def test_heartbeat_deregister():
    mon = HeartbeatMonitor(timeout_s=0.05)
    mon.register("s0")
    mon.register("s1")
    mon.deregister("s0")
    assert mon.healthy_servers() == ["s1"]
    time.sleep(0.08)                     # let s0's old beat age out
    mon.beat("s1")
    assert mon.sweep() == []             # s0 gone, not a zombie eviction
    assert mon.evictions == []


def test_heartbeat_beat_fault_lapses_a_healthy_server():
    evicted = []
    mon = HeartbeatMonitor(timeout_s=0.05, on_evict=evicted.append,
                           faults=FaultInjector("beat@1..99"))
    mon.register("s0")
    mon.beat("s0")                       # call 0 lands
    t0 = time.monotonic()
    while not mon.sweep():               # every later beat is swallowed
        mon.beat("s0")
        assert time.monotonic() - t0 < T_OUT
        time.sleep(0.005)
    assert evicted == ["s0"] and not mon.is_healthy("s0")
    assert mon.registry.counter("heartbeat.evictions") == 1
    assert mon.registry.gauge("heartbeat.healthy_servers") == 0


# ---------------------------------------------------------------------------
# agent sessions
# ---------------------------------------------------------------------------

def test_agent_session_reuses_history_and_matches_oracle():
    jcfg, params, model = family("gqa")
    rng = np.random.default_rng(6)
    kw = dict(max_batch=2, block_size=8, num_blocks=64, max_len=256)
    eng = ContinuousEngine(model.cfg, model, device="cpu", **kw)
    off = ContinuousEngine(model.cfg, model, device="cpu",
                           prefix_cache=False, **kw)
    sess = AgentSession(eng)
    jsess = JaxSession(JaxEngine(jcfg, params, **kw))
    conv, prompts, outs, jouts = [], [], [], []
    for turn in range(4):
        msg = rng.integers(3, jcfg.vocab_size, size=9).astype(np.int32)
        out = sess.send(msg, max_new=5)
        ref = Request(prompt=np.asarray(conv + list(msg), np.int32),
                      max_new=5)
        off.serve([ref])
        np.testing.assert_array_equal(out, ref.out)
        prompts.append(ref.prompt)
        outs.append(out)
        jouts.append(np.asarray(jsess.send(msg, max_new=5)))
        conv = conv + list(msg) + list(ref.out)
        if turn > 0:
            # turn N+1 prefills ~the new message, not the whole history
            assert sess.last_turn["cached_tokens"] > 0
            assert sess.last_turn["prefill_tokens"] \
                < sess.last_turn["prompt_tokens"]
        assert sess.pinned_blocks > 0
    sess.close()
    jsess.close()
    assert sess.pinned_blocks == 0
    eng.reset_cache()
    assert eng.kv.free_blocks == eng.kv.num_blocks
    # JAX's session, turn by turn while the histories agree: a turn
    # without the margin ends the comparison (later prompts may differ)
    compared = 0
    for p, a, b in zip(prompts, outs, jouts):
        if not margin_ok(model, p, a):
            break
        np.testing.assert_array_equal(a, b)
        compared += 1
    assert compared > 0


def test_session_pin_survives_eviction_pressure():
    _, _, model = family("gqa")
    eng = ContinuousEngine(model.cfg, model, device="cpu", max_batch=1,
                           block_size=8, num_blocks=8, max_len=64)
    sess = AgentSession(eng)
    sess.send(np.arange(3, 19, dtype=np.int32), max_new=4)   # pins blocks
    pinned = sess.pinned_blocks
    assert pinned > 0
    [cold] = eng.serve([Request(prompt=np.full(40, 7, np.int32), max_new=8)])
    assert cold.status == "shed"
    assert isinstance(cold.error, RequestShed) and cold.out is None
    assert sess.pinned_blocks == pinned                      # untouched
    sess.close()
    [warm] = eng.serve([Request(prompt=np.full(40, 7, np.int32), max_new=8)])
    assert warm.status == "ok" and len(warm.out) == 8


def test_spec_agent_session_turns_byte_identical():
    _, _, model = family("gqa", mtp=True)
    rng = np.random.default_rng(17)
    msgs = [rng.integers(3, 256, size=k).astype(np.int32) for k in (9, 5)]

    def converse(spec):
        eng = ContinuousEngine(model.cfg, model, spec_steps=spec,
                               device="cpu", max_batch=2, block_size=8,
                               num_blocks=32, max_len=64)
        sess = AgentSession(eng)
        replies = [sess.send(m, max_new=5) for m in msgs]
        stats = dict(sess.last_turn)
        sess.close()
        return replies, stats

    ref, stats0 = converse(0)
    out, stats4 = converse(4)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a, b)
    assert stats0["draft_tokens"] == 0 and stats0["accepted_tokens"] == 0
    assert stats4["draft_tokens"] > 0
    assert stats4["accepted_tokens"] >= 1
