"""PyTorch port, serving: allocator, radix cache and the continuous engine.

* Allocator and radix units mirrored from the reference's
  ``test_paged_serving.py`` / ``test_prefix_cache.py`` (the port keeps its
  own copies of these host modules): refcount conservation, double free,
  LRU order, COW isolation, stale-first eviction after a weight push.
* Engine parity on the SAME weights (bridged from JAX): the port's
  ``ContinuousEngine`` gives the greedy tokens of the JAX
  ``ContinuousEngine`` and of the JAX ``ServingEngine`` oracle, on mixed
  lengths with mid-flight admission, a radix hit with a COW fork, whole
  and chunked prefill.  Token equality across frameworks is claimed only
  where the top-2 logit margin (teacher-forced) is at least 1e-4.
* The same for the MLA family (the JAX serving tests' ``_family_cfg("mla")``
  — GLM-5 smoke MLA geometry, one dense-MLP layer first — with
  ``dsa=None``) and for its variant with 4 routed experts top-2 plus a
  shared expert: latent ``c``/``kr`` pools, COW forks that copy both.
* Inside the port, ``attn_impl="kernel"`` and ``"ref"`` give identical
  tokens; the configurations the engine does not serve raise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.faults import FaultInjector, InjectedFault
from repro_torch.models import transformer as T
from repro_torch.serving import (CacheFull, ContinuousEngine, PagedKVCache,
                                 PrefixCache, Request, RequestCancelled,
                                 ServingEngine)
from _torch_threads import one_torch_thread  # noqa: F401

MARGIN = 1e-4


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@pytest.fixture(scope="module")
def setup():
    jcfg = get_smoke_config("yi_6b").replace(
        d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256, dsa=None)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_cfg(jcfg), device="cpu")
    return jcfg, params, model


def _workload(vocab, seed=1):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(3, vocab, size=21)            # ends mid-block
    prompts = [np.concatenate([sys_p, rng.integers(3, vocab, size=n)])
               for n in (5, 9, 3, 13)]
    prompts.append(prompts[0].copy())                  # exact duplicate
    prompts.append(rng.integers(3, vocab, size=7))
    return [p.astype(np.int32) for p in prompts], [4, 6, 3, 5, 4, 2]


def _margin_ok(model, prompt, out):
    seq = torch.from_numpy(np.concatenate([prompt, out[:-1]]).astype(np.int64))
    lg = T.logits(model, seq[None])[0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= MARGIN).all())


@pytest.fixture(scope="module")
def jax_outputs(setup):
    """Greedy tokens of the JAX oracle and of the JAX continuous engine
    (whole and chunked prefill) on the shared workload."""
    jcfg, params, _ = setup
    prompts, max_new = _workload(jcfg.vocab_size)
    oracle = [JaxRequest(prompt=p, max_new=m)
              for p, m in zip(prompts, max_new)]
    JaxOracle(jcfg, params, max_batch=1, max_len=64).serve(oracle)
    out = {"oracle": [r.out for r in oracle]}
    for chunk in (None, 8):
        reqs = [JaxRequest(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        JaxEngine(jcfg, params, max_batch=2, block_size=8, num_blocks=32,
                  max_len=64, prefill_chunk=chunk).serve(reqs)
        out[chunk] = [r.out for r in reqs]
    return out


# ---------------------------------------------------------------------------
# engine parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 8])
def test_engine_matches_jax_engine_and_oracle(setup, jax_outputs, chunk):
    jcfg, _, model = setup
    prompts, max_new = _workload(jcfg.vocab_size)
    outs = {}
    for impl in ("kernel", "ref"):
        eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                               num_blocks=32, max_len=64,
                               prefill_chunk=chunk, attn_impl=impl,
                               device="cpu")
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        outs[impl] = [r.out for r in reqs]
        # the workload really exercised reuse, COW and mid-flight admission
        assert eng.stats["cached_tokens"] > 0
        assert eng.stats["cow_forks"] > 0
        assert any(s > 0 for s in eng.stats["admit_steps"])
        assert eng.stats["compiles"] == 0
        assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks
    for a, b in zip(outs["kernel"], outs["ref"]):      # exact, in the port
        np.testing.assert_array_equal(a, b)
    compared = 0
    for i, (p, got) in enumerate(zip(prompts, outs["kernel"])):
        if not _margin_ok(model, p, jax_outputs["oracle"][i]):
            continue
        compared += 1
        np.testing.assert_array_equal(got, jax_outputs["oracle"][i])
        np.testing.assert_array_equal(got, jax_outputs[chunk][i])
    assert compared >= 4


def _mla_cfg(experts):
    """``tests/test_paged_attention.py``'s ``_family_cfg("mla")`` with
    ``dsa=None`` (the DSA slice is not ported), optionally with experts."""
    return get_smoke_config("glm5_744b").replace(
        d_model=128, num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=256,
        num_experts=experts, num_shared_experts=1 if experts else 0,
        mtp=None, first_k_dense=1, dsa=None, moe_impl="dense")


@pytest.fixture(scope="module", params=[0, 4], ids=["mla", "mla_moe4"])
def mla_setup(request):
    jcfg = _mla_cfg(request.param)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_cfg(jcfg), device="cpu")
    return jcfg, params, model


@pytest.mark.parametrize("chunk", [None, 8])
def test_mla_engine_matches_jax_engine_and_oracle(mla_setup, chunk):
    jcfg, params, model = mla_setup
    prompts, max_new = _workload(jcfg.vocab_size, seed=8)
    oracle = [JaxRequest(prompt=p, max_new=m)
              for p, m in zip(prompts, max_new)]
    JaxOracle(jcfg, params, max_batch=1, max_len=64).serve(oracle)
    jreqs = [JaxRequest(prompt=p, max_new=m)
             for p, m in zip(prompts, max_new)]
    JaxEngine(jcfg, params, max_batch=2, block_size=8, num_blocks=32,
              max_len=64, prefill_chunk=chunk).serve(jreqs)
    outs = {}
    for impl in ("kernel", "ref"):
        eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                               num_blocks=32, max_len=64,
                               prefill_chunk=chunk, attn_impl=impl,
                               device="cpu")
        assert set(eng.pool["slot0"]) == {"c", "kr"}
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        outs[impl] = [r.out for r in reqs]
        assert eng.stats["cached_tokens"] > 0
        assert eng.stats["cow_forks"] > 0
        assert any(s > 0 for s in eng.stats["admit_steps"])
        assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks
        if impl == "kernel":
            assert eng.stats["gather_bytes_saved"] > 0
    for a, b in zip(outs["kernel"], outs["ref"]):      # exact, in the port
        np.testing.assert_array_equal(a, b)
    compared = 0
    for p, got, o, j in zip(prompts, outs["kernel"], oracle, jreqs):
        if not _margin_ok(model, p, o.out):
            continue
        compared += 1
        np.testing.assert_array_equal(got, o.out)
        np.testing.assert_array_equal(got, j.out)
    assert compared >= 4


def test_port_engine_matches_port_oracle_mixed_lengths(setup):
    jcfg, _, model = setup
    rng = np.random.default_rng(3)
    plens, maxnew = [5, 17, 9, 33, 1, 26], [3, 9, 5, 12, 1, 7]
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in plens]
    eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                           num_blocks=24, max_len=64, device="cpu")
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, maxnew)]
    eng.serve(reqs)
    oreqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, maxnew)]
    ServingEngine(model.cfg, model, max_batch=1, max_len=64,
                  device="cpu").serve(oreqs)
    for r, o in zip(reqs, oreqs):
        np.testing.assert_array_equal(r.out, o.out)
        assert r.status == "ok" and r.out_version == 0
    assert set(eng.latency_summary()) == {"ttft_ms", "tpot_ms", "latency_ms",
                                          "queue_ms"}


def test_cow_isolation_and_eviction_under_pressure(setup):
    jcfg, _, model = setup
    rng = np.random.default_rng(4)
    base = rng.integers(3, jcfg.vocab_size, size=13).astype(np.int32)
    fork = base.copy()
    fork[10] = (fork[10] + 1) % jcfg.vocab_size     # diverge inside block 2
    eng = ContinuousEngine(model.cfg, model, max_batch=1, block_size=8,
                           num_blocks=8, max_len=64, device="cpu")
    oracle = ServingEngine(model.cfg, model, max_batch=1, max_len=64,
                           device="cpu")
    extra = [rng.integers(3, jcfg.vocab_size, size=17).astype(np.int32)
             for _ in range(3)]
    for prompt in (base, fork, base, fork, *extra):
        r, o = Request(prompt=prompt, max_new=4), Request(prompt=prompt,
                                                          max_new=4)
        eng.serve([r])
        oracle.serve([o])
        np.testing.assert_array_equal(r.out, o.out)
    assert eng.stats["cow_forks"] >= 2
    assert eng.prefix.stats["evictions"] > 0
    assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks


def test_push_weights_drains_and_refuses_stale_blocks(setup):
    jcfg, _, model = setup
    prompt = np.random.default_rng(5).integers(
        3, jcfg.vocab_size, size=20).astype(np.int32)
    eng = ContinuousEngine(model.cfg, model, max_batch=1, block_size=8,
                           num_blocks=16, max_len=64, device="cpu")
    first = Request(prompt=prompt, max_new=6)
    eng.submit(first)
    eng.step()                                  # in flight
    new = T.init(model.cfg, torch.Generator().manual_seed(7), device="cpu")
    assert eng.push_weights(new, 1) is False    # deferred: drain barrier
    eng.serve([])
    assert eng.weight_version == 1 and first.out_version == 0
    second = Request(prompt=prompt, max_new=6)
    eng.serve([second])
    assert eng.prefix.stats["version_refused"] > 0
    assert second.out_version == 1
    o = Request(prompt=prompt, max_new=6)
    ServingEngine(model.cfg, new, max_batch=1, max_len=64,
                  device="cpu").serve([o])
    np.testing.assert_array_equal(second.out, o.out)


def test_cancel_mid_flight_and_deadline(setup):
    jcfg, _, model = setup
    rng = np.random.default_rng(6)
    eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                           num_blocks=16, max_len=64, device="cpu")
    a = Request(prompt=rng.integers(3, 256, 12).astype(np.int32), max_new=8)
    b = Request(prompt=rng.integers(3, 256, 9).astype(np.int32), max_new=8,
                deadline_s=0.0)
    eng.submit(a)
    eng.step()
    assert eng.cancel(a.rid) and a.status == "cancelled"
    assert isinstance(a.error, RequestCancelled)
    eng.submit(b)
    eng.serve([])
    assert b.status == "deadline"
    assert eng.stats["cancels"] == 1 and eng.stats["deadline_expired"] == 1
    assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks


@pytest.mark.parametrize("spec", ["prefill@1", "admit@1"])
def test_injected_request_fault_is_isolated(setup, spec):
    jcfg, _, model = setup
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (11, 6, 14)]
    eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                           num_blocks=16, max_len=64, device="cpu",
                           faults=FaultInjector(spec))
    reqs = [Request(prompt=p, max_new=4) for p in prompts]
    eng.serve(reqs)
    assert [r.status for r in reqs] == ["ok", "failed", "ok"]
    assert isinstance(reqs[1].error, InjectedFault)
    assert eng.stats["request_faults"] == 1
    oreqs = [Request(prompt=p, max_new=4) for p in prompts]
    ServingEngine(model.cfg, model, max_batch=1, max_len=64,
                  device="cpu").serve(oreqs)
    for i in (0, 2):
        np.testing.assert_array_equal(reqs[i].out, oreqs[i].out)
    assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks


@pytest.mark.parametrize("spec", ["worker@1", "worker~0.5", "worker"])
def test_fault_points_the_port_does_not_wire_are_refused(spec):
    # the orchestrator's point is wired since its port (every point of the
    # reference is); a point nothing wires, in the same clause form, is not
    assert FaultInjector(spec).armed("worker")
    with pytest.raises(ValueError, match="unknown point"):
        FaultInjector(spec.replace("worker", "wroker"))


def test_alloc_fault_storm_raises_cache_full():
    kv = PagedKVCache(num_blocks=8, block_size=4,
                      faults=FaultInjector("alloc@1..2"))
    kv.alloc(1)
    for _ in range(2):
        with pytest.raises(CacheFull):
            kv.alloc(1)
    kv.alloc(1)
    assert kv.used_blocks == 2


def test_engine_rejects_later_slices(setup):
    _, _, model = setup
    kw = dict(max_batch=1, block_size=8, num_blocks=8, max_len=64,
              device="cpu")
    with pytest.raises(ValueError, match="MTP"):  # served, with a head
        ContinuousEngine(model.cfg, model, spec_steps=2, **kw)
    with pytest.raises(NotImplementedError):   # the static engine's family
        ContinuousEngine(dataclasses.replace(model.cfg, family="ssm"),
                         model, **kw)
    with pytest.raises(ValueError):
        ContinuousEngine(model.cfg, model, attn_impl="pallas", **kw)


# ---------------------------------------------------------------------------
# allocator and radix tree (no model)
# ---------------------------------------------------------------------------

def test_alloc_free_invariants_and_refcounts():
    kv = PagedKVCache(num_blocks=8, block_size=4)
    a = kv.alloc(3)
    b = kv.alloc(5)
    assert sorted(a + b) == list(range(8))
    with pytest.raises(CacheFull):
        kv.alloc(1)
    kv.free(b)
    kv.retain(a)
    kv.retain([a[0]])
    assert [kv.refcount(x) for x in a] == [3, 2, 2]
    with pytest.raises(ValueError):                 # free() needs ref 1
        kv.free(a)
    with pytest.raises(ValueError):                 # duplicates in retain
        kv.retain([a[1], a[1]])
    kv.release(a)
    kv.release(a)
    assert kv.used_blocks == 1 and kv.refcount(a[0]) == 1
    kv.release([a[0]])
    assert kv.free_blocks == kv.num_blocks and kv.used_blocks == 0
    with pytest.raises(ValueError):                 # double release
        kv.release([a[0]])
    with pytest.raises(ValueError):                 # foreign block
        kv.free([99])


def _insert_seq(cache, kv, tokens):
    blocks = kv.alloc(kv.blocks_for(len(tokens)))
    cache.insert(tokens, blocks)
    return blocks


def test_radix_match_partial_dedup_and_lru_order():
    kv = PagedKVCache(num_blocks=16, block_size=4)
    cache = PrefixCache(kv)
    _insert_seq(cache, kv, list(range(1, 11)))      # 2 full + [9, 10]
    m, blocks = cache.match(list(range(1, 13)))
    assert m == 10 and len(blocks) == 3
    kv.release(blocks)
    m, blocks = cache.match([1, 2, 3, 4, 5, 6, 9, 9])  # diverges mid-block
    assert m == 6 and len(blocks) == 2
    kv.release(blocks)
    free_before = kv.free_blocks
    dup = _insert_seq(cache, kv, list(range(1, 9)))    # identical content
    assert cache.cached_blocks == 3 and kv.free_blocks == free_before
    assert all(kv.refcount(x) == 0 for x in dup)
    # LRU: touch chain A, evict 1 -> chain B's leaf goes first
    kv2 = PagedKVCache(num_blocks=4, block_size=4)
    c2 = PrefixCache(kv2)
    _insert_seq(c2, kv2, list(range(0, 8)))
    _insert_seq(c2, kv2, list(range(100, 108)))
    m, held = c2.match(list(range(0, 8)))
    assert c2.evict(10) == 2                       # A is referenced: B only
    kv2.release(held)
    assert c2.evict(10) == 2 and kv2.free_blocks == kv2.num_blocks


def test_stale_blocks_evicted_first_and_refused_after_push():
    kv = PagedKVCache(num_blocks=4, block_size=4)
    cache = PrefixCache(kv)
    demoted = []
    kv.demote_hook = lambda path, block, version: demoted.append(version)
    _insert_seq(cache, kv, list(range(0, 4)))      # written under v0
    kv.set_version(1)
    _insert_seq(cache, kv, list(range(50, 54)))    # written under v1
    m, blocks = cache.match(list(range(0, 4)) + [9])
    assert m == 0 and cache.stats["version_refused"] == 1
    assert cache.stale_cached_blocks == 1
    assert cache.evict(1) == 1                     # the stale one first
    assert cache.stats["stale_evictions"] == 1 and demoted == []
    assert cache.match(list(range(50, 54)) + [1])[0] == 4
