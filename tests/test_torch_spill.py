"""PyTorch port, the host-RAM prefix spill tier (``serving.spill``) on the
CPU.

Mirrors ``tests/test_spill.py`` on the port, all twelve tests, with the
reference tests' family configs and weights bridged from JAX
(``tests/_torch_families.py``), fp32:

* demote/restore BIT parity at the pool level (a fake engine, no model):
  the restored rows equal the demoted rows bit for bit, restamped to the
  writer version, entries consumed; and at the engine level per family
  (GQA, GQA + DSA, MLA): greedy tokens with the tier on equal those with
  it off, restored-prefix hits > 0, prefill tokens saved, and the shared
  prefix's cached rows bit-identical on and off;
* the conservation property over allocator + radix tree + tier under
  random demote / restore / evict / push / pin interleavings;
* the version contract across the tier: entries stale at lookup dropped,
  blocks stale at eviction never demoted; the capacity bound (oldest entry
  drops), partial tails never spilled, re-demote refreshing;
* restore composing with COW forks and ``AgentSession`` pins;
* engine wiring: ``spill=`` / ``REPRO_SPILL_ENABLE`` / ``REPRO_SPILL_BLOCKS``,
  ``respawn()`` keeping the tier, ``reset_cache()`` clearing it (on the
  respawned engine: the port's ``respawn`` releases the dead engine's
  pool, so the reference's later use of the old engine has no
  counterpart);
* the satellite regressions: the partial-overlap scan counting
  ``version_refused``, ``retain()`` rejecting duplicates atomically;
* one cross-framework case: the port's tokens with the tier on equal
  JAX's ``ContinuousEngine`` with its tier on (where the top-2 margin is
  at least 1e-4).

The reference's padded power-of-two scatter jit has no counterpart: the
port writes the rows in place with ``index_copy_``.
"""
import functools

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from _torch_families import assert_tokens_match, family
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro_torch.serving import (AgentSession, CacheFull, ContinuousEngine,
                                 HostSpillTier, PagedKVCache, PrefixCache,
                                 Request)
from repro_torch.serving.spill import pool_leaves


class _FakeEngine:
    """The spill tier's engine contract without a model: a refcounted
    allocator plus a layer-major pool filled with random values (leaf
    shape ``(L * (num_blocks + 1), block_size, feat)``)."""

    def __init__(self, num_blocks=8, block_size=4, L=2, feat=3, seed=0):
        self.kv = PagedKVCache(num_blocks, block_size)
        gen = torch.Generator().manual_seed(seed)
        shape = (L * (num_blocks + 1), block_size, feat)
        self.pool = {"k": torch.randn(shape, generator=gen),
                     "v": torch.randn(shape, generator=gen)}
        self._L, self._stride = L, num_blocks + 1

    def rows(self, leaf_name, block):
        idx = torch.arange(self._L) * self._stride + block
        return self.pool[leaf_name][idx].clone()


def _setup(num_blocks=8, block_size=4, capacity=None, **kw):
    eng = _FakeEngine(num_blocks=num_blocks, block_size=block_size, **kw)
    prefix = PrefixCache(eng.kv)
    tier = HostSpillTier(eng, capacity_blocks=capacity)
    tier.attach(prefix)
    return eng, prefix, tier


def _conserved(eng, prefix):
    kv = eng.kv
    assert kv.free_blocks + kv.used_blocks == kv.num_blocks
    nodes = list(prefix._iter_nodes())
    assert all(kv.refcount(n.block) >= 1 for n in nodes)


def _bits(t):
    """A tensor's bytes, for bit-for-bit comparison (-0.0 and NaN too)."""
    return t.contiguous().view(torch.uint8)


# ---------------------------------------------------------------------------
# pool-level demote/restore (no model)
# ---------------------------------------------------------------------------

def test_demote_restore_byte_parity_and_conservation():
    eng, prefix, tier = _setup()
    bs = 4
    toks = list(range(10, 10 + 2 * bs))
    blocks = eng.kv.alloc(2)
    expected = {(n, b): eng.rows(n, b) for n in eng.pool for b in blocks}
    prefix.insert(toks, blocks)
    # allocation pressure unwinds the cold chain tail-first -> demoted
    assert prefix.evict(2) == 2
    assert tier.spilled_blocks == 2 and eng.kv.used_blocks == 0
    assert eng.kv.registry.counter("spill.demotions") == 2
    # scribble over the freed rows: the restore must bring the bytes back
    for leaf in eng.pool.values():
        leaf.fill_(7.0)
    m, mb = prefix.match(toks)
    assert m == 2 * bs and len(mb) == 2
    assert eng.kv.registry.counter("spill.restores") == 1
    assert eng.kv.registry.counter("spill.restored_blocks") == 2
    assert tier.spilled_blocks == 0               # entries consumed
    for name in eng.pool:
        for orig, b in zip(blocks, mb):
            assert torch.equal(_bits(eng.rows(name, b)),
                               _bits(expected[(name, orig)]))
    assert all(eng.kv.block_version(b) == 0 for b in mb)
    eng.kv.release(mb)
    _conserved(eng, prefix)
    m2, mb2 = prefix.match(toks)                  # now a plain warm hit
    assert m2 == 2 * bs
    assert eng.kv.registry.counter("spill.restores") == 1
    eng.kv.release(mb2)
    _conserved(eng, prefix)


def test_stale_spilled_entries_dropped_never_restored():
    eng, prefix, tier = _setup()
    toks = list(range(20, 28))
    prefix.insert(toks, eng.kv.alloc(2))
    prefix.evict(2)
    assert tier.spilled_blocks == 2
    eng.kv.set_version(1)                         # a weight push lands
    m, mb = prefix.match(toks)
    assert m == 0 and mb == []                    # miss, not stale KV
    assert eng.kv.registry.counter("spill.dropped_stale") >= 1
    assert eng.kv.registry.counter("spill.restores") == 0
    _conserved(eng, prefix)


def test_stale_blocks_never_demoted():
    eng, prefix, tier = _setup()
    prefix.insert(list(range(30, 34)), eng.kv.alloc(1))
    eng.kv.set_version(1)                         # block is now stale
    assert prefix.evict(1) == 1
    assert tier.spilled_blocks == 0               # forgotten, not spilled
    assert prefix.stats["stale_evictions"] == 1
    assert eng.kv.registry.counter("spill.demotions") == 0


def test_partial_tail_leaves_never_demoted():
    eng, prefix, tier = _setup()
    prefix.insert([40, 41, 42], eng.kv.alloc(1))  # 3 tokens < block_size
    assert prefix.evict(1) == 1
    assert tier.spilled_blocks == 0
    assert eng.kv.registry.counter("spill.demotions") == 0


def test_capacity_bound_drops_oldest_entry():
    eng, prefix, tier = _setup(num_blocks=12, capacity=2)
    paths = []
    for f in range(3):                            # three 1-block prefixes
        toks = [100 * (f + 1) + j for j in range(4)]
        paths.append(tuple(toks))
        prefix.insert(toks, eng.kv.alloc(1))
    assert prefix.evict(3) == 3                   # LRU: oldest demotes first
    assert eng.kv.registry.counter("spill.demotions") == 3
    assert eng.kv.registry.counter("spill.dropped_capacity") == 1
    assert tier.spilled_blocks == 2
    assert not tier.has(paths[0])                 # the oldest fell off
    assert tier.has(paths[1]) and tier.has(paths[2])
    assert eng.kv.registry.gauge("spill.blocks") == 2


def test_redemote_refreshes_in_place():
    eng, prefix, tier = _setup(capacity=4)
    toks = list(range(50, 54))
    prefix.insert(toks, eng.kv.alloc(1))
    prefix.evict(1)
    m, mb = prefix.match(toks)                    # restore consumes entry
    eng.kv.release(mb)
    prefix.evict(1)                               # demote the path again
    assert tier.spilled_blocks == 1
    assert eng.kv.registry.counter("spill.demotions") == 2
    _conserved(eng, prefix)


# ---------------------------------------------------------------------------
# property: conservation across demote/restore/evict/push interleavings
# ---------------------------------------------------------------------------

_SPILL_OPS = st.lists(st.tuples(st.sampled_from(
    ["insert", "match", "evict", "push", "pin", "unpin", "clear_spill"]),
    st.integers(min_value=0, max_value=11)), min_size=1, max_size=20)


@settings(max_examples=15, deadline=None)
@given(_SPILL_OPS)
def test_property_conservation_under_spill_interleavings(ops):
    eng, prefix, tier = _setup(num_blocks=12, capacity=6)
    kv, bs = eng.kv, 4
    version = 0
    pins = []

    def toks(f, n):
        # four token families; chains within a family share prefixes, so
        # inserts and matches exercise dedupe, graft and chain restore
        return [50 * (f + 1) + j for j in range(n * bs)]

    for op, arg in ops:
        f, n = arg % 4, 1 + arg % 3
        if op == "insert":
            try:
                blocks = kv.alloc(n)
            except CacheFull:
                continue
            prefix.insert(toks(f, n), blocks)
        elif op == "match":
            m, mb = prefix.match(toks(f, n))
            assert m == len(mb) * bs              # full blocks only
            if mb:
                kv.release(mb)
        elif op == "evict":
            prefix.evict(1 + arg % 3)
        elif op == "push":
            version += 1
            kv.set_version(version)
        elif op == "pin":                         # a reader holds on
            m, mb = prefix.match(toks(f, n))
            if mb:
                pins.append(mb)
        elif op == "unpin" and pins:
            kv.release(pins.pop(arg % len(pins)))
        elif op == "clear_spill":
            tier.clear()
        _conserved(eng, prefix)
        if tier.capacity_blocks is not None:
            assert tier.spilled_blocks <= tier.capacity_blocks
    for mb in pins:
        kv.release(mb)
    _conserved(eng, prefix)
    nodes = list(prefix._iter_nodes())
    assert kv.used_blocks == len({nd.block for nd in nodes})
    prefix.clear()
    assert kv.free_blocks == kv.num_blocks


# ---------------------------------------------------------------------------
# satellite regressions
# ---------------------------------------------------------------------------

def test_partial_overlap_stale_child_counts_version_refused():
    kv = PagedKVCache(num_blocks=8, block_size=8)
    prefix = PrefixCache(kv)
    prefix.insert([10, 11, 12, 13, 14], kv.alloc(1))
    kv.set_version(1)
    m, mb = prefix.match([10, 11, 12, 13, 14])
    assert m == 0 and mb == []
    assert prefix.stats["version_refused"] == 1
    prefix.insert(list(range(20, 28)), kv.alloc(1))
    kv.set_version(2)
    m, mb = prefix.match([20, 21, 22, 99, 99, 99, 99, 99])
    assert m == 0 and mb == []
    assert prefix.stats["version_refused"] == 2


def test_retain_rejects_duplicates_atomically():
    kv = PagedKVCache(num_blocks=4, block_size=4)
    a = kv.alloc(2)
    with pytest.raises(ValueError, match="duplicate"):
        kv.retain([a[0], a[0]])
    assert [kv.refcount(b) for b in a] == [1, 1]  # nothing half-applied
    with pytest.raises(ValueError, match="duplicate"):
        kv.retain([a[0], a[1], a[0]])
    assert [kv.refcount(b) for b in a] == [1, 1]
    kv.retain(a)                                  # valid aliasing works
    assert [kv.refcount(b) for b in a] == [2, 2]


# ---------------------------------------------------------------------------
# engine level: parity per family, COW composition, sessions, wiring
# ---------------------------------------------------------------------------

_KW = dict(max_batch=2, block_size=8, num_blocks=24, max_len=96)


def _spill_workload(vocab=256):
    """A pool-overflowing trace: a shared prefix, filler pressure that
    evicts it, the shared prefix again (the restore hit), and a mid-block
    divergence of it (a COW fork off a restored block)."""
    rng = np.random.default_rng(7)
    shared = rng.integers(3, vocab, size=40).astype(np.int32)
    fillers = [rng.integers(3, vocab, size=48).astype(np.int32)
               for _ in range(4)]
    div = np.concatenate([shared[:20],
                          rng.integers(3, vocab, size=12).astype(np.int32)])
    return [shared, *fillers, shared, div]


def _cached_rows(eng, tokens):
    """The cached prefix's rows of every pool leaf, in position order."""
    m, blocks = eng.prefix.match(tokens)
    try:
        stride = eng.kv.num_blocks + 1
        out = []
        for leaf in pool_leaves(eng.pool):
            L = leaf.shape[0] // stride
            idx = (torch.arange(L)[:, None] * stride
                   + torch.tensor(blocks)[None, :]).reshape(-1)
            out.append(leaf[idx].clone())
        return m, out
    finally:
        eng.kv.release(blocks)


def _run_trace(model, prompts, **kw):
    eng = ContinuousEngine(model.cfg, model, device="cpu",
                           **dict(_KW, **kw))
    outs, rows = [], None
    for i, p in enumerate(prompts):
        r = Request(prompt=p, max_new=6)
        eng.serve([r])
        assert r.error is None, r.error
        outs.append(np.asarray(r.out))
        if i == 5:                        # the shared prefix, served again
            rows = _cached_rows(eng, prompts[0])
    return eng, outs, rows


@pytest.mark.parametrize("family_name", ["gqa", "dsa", "mla"])
def test_engine_spill_byte_parity(family_name):
    _, _, model = family(family_name)
    prompts = _spill_workload()
    off_eng, off, off_rows = _run_trace(model, prompts, spill=False)
    on_eng, on, on_rows = _run_trace(model, prompts, spill=True,
                                     spill_blocks=64)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)       # byte-exact greedy
    reg = on_eng.registry
    assert reg.counter("spill.demotions") > 0
    assert reg.counter("spill.restores") > 0      # restored-prefix hits
    assert on_eng.stats["prefill_tokens"] < off_eng.stats["prefill_tokens"]
    assert on_eng.stats["cow_forks"] >= 1
    # the shared prefix's cached KV: restored rows (spill on) bit-equal to
    # the re-prefilled rows (spill off)
    assert on_rows[0] == off_rows[0] >= 32
    for a, b in zip(on_rows[1], off_rows[1]):
        assert torch.equal(_bits(a), _bits(b))
    kv = on_eng.kv
    assert kv.free_blocks + kv.used_blocks == kv.num_blocks


def test_engine_spill_matches_jax_engine_with_spill():
    jcfg, params, model = family("gqa")
    prompts = _spill_workload()
    _, on, _ = _run_trace(model, prompts, spill=True, spill_blocks=64)
    jeng = JaxEngine(jcfg, params, spill=True, spill_blocks=64, **_KW)
    jouts = []
    for p in prompts:
        r = JaxRequest(prompt=p, max_new=6)
        jeng.serve([r])
        jouts.append(np.asarray(r.out))
    assert jeng.registry.counter("spill.restores") > 0
    assert_tokens_match(model, prompts, on, jouts)


def test_restore_composes_with_session_pins():
    _, _, model = family("gqa")
    rng = np.random.default_rng(9)
    msgs = [rng.integers(3, 256, size=10).astype(np.int32)
            for _ in range(2)]
    fillers = [rng.integers(3, 256, size=48).astype(np.int32)
               for _ in range(4)]
    shared = rng.integers(3, 256, size=40).astype(np.int32)

    def run(spill):
        eng = ContinuousEngine(model.cfg, model, device="cpu", spill=spill,
                               spill_blocks=64, **_KW)
        sess = AgentSession(eng)
        outs = [np.asarray(sess.send(msgs[0], max_new=4))]
        pinned = sess.pinned_blocks
        assert pinned > 0
        eng.serve([Request(prompt=shared, max_new=4)])     # cache it
        for f in fillers:                  # churn: evict/demote the rest
            eng.serve([Request(prompt=f, max_new=4)])
        assert sess.pinned_blocks == pinned        # pins never spill away
        # a restore allocates landing blocks UNDER the pins
        eng.serve([Request(prompt=shared, max_new=4)])
        outs.append(np.asarray(sess.send(msgs[1], max_new=4)))
        sess.close()
        kv = eng.kv
        assert kv.free_blocks + kv.used_blocks == kv.num_blocks
        return outs, eng

    off, _ = run(False)
    on, eng = run(True)
    for a, b in zip(off, on):
        np.testing.assert_array_equal(a, b)
    assert eng.registry.counter("spill.restores") > 0


def test_engine_spill_wiring_flag_respawn_reset(monkeypatch):
    _, _, model = family("gqa")
    eng = ContinuousEngine(model.cfg, model, device="cpu", spill=True,
                           **_KW)
    assert eng.spill_tier is not None
    assert eng._init_kw["spill"] is True
    # respawn (supervisor crash recovery) reproduces the tier
    eng2 = eng.respawn()
    assert eng2.spill_tier is not None and eng2.spill_tier is not \
        eng.spill_tier
    # reset_cache drops the spilled entries too (benchmark hygiene)
    b = eng2.kv.alloc(1)
    assert eng2.spill_tier.demote((1, 2, 3), b[0], 0)
    assert eng2.spilled_blocks == 1
    eng2.reset_cache()
    assert eng2.spilled_blocks == 0
    eng2.kv.release(b)
    # cache-off engines never get a tier, even with spill requested
    off = ContinuousEngine(model.cfg, model, device="cpu", spill=True,
                           prefix_cache=False, **_KW)
    assert off.spill_tier is None
    # the env default wires the tier when spill= is not passed
    monkeypatch.setenv("REPRO_SPILL_ENABLE", "1")
    monkeypatch.setenv("REPRO_SPILL_BLOCKS", "7")
    env_eng = ContinuousEngine(model.cfg, model, device="cpu", **_KW)
    assert env_eng.spill_tier is not None
    assert env_eng.spill_tier.capacity_blocks == 7
