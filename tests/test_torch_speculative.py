"""PyTorch port, MTP speculative decode (``ContinuousEngine(spec_steps=n)``,
``serving.speculative``, ``core.mtp``), on the CPU against the JAX package.

Mirrors ``tests/test_speculative.py`` on the port, with weights bridged
from the reference (``from_jax_params``), fp32:

* engine greedy tokens identical for ``spec_steps`` in {2, 4} and 0, for
  GQA, GQA + DSA and MLA, through mid-flight admission and retirement
  (staggered budgets through 2 slots) and a radix-suffix admission with a
  COW fork; the spec stats sane; and equal to JAX's engine at the same
  ``spec_steps`` (tokens, drafted and accepted counts), for those three and
  for GLM-5's whole smoke config (MLA + DSA + MoE + MTP, spec 3);
* ``mtp_draft`` tokens and ``verify_step`` logits and hidden states against
  JAX's (atol 1e-4 of unit-scale values), and the MTP head's training
  term through ``transformer.loss`` (``tests/test_torch_train.py``);
* accept-length semantics: ``speculative_accept_length`` on all / none /
  middle / last mismatches; ``measure_accept_length`` paged (both routes)
  equal to its ref oracle and to JAX's, accept lengths and tokens;
* rollback: a spec round across a block boundary truncates to the accept
  point and never allocates, the allocator is conserved throughout; a
  speculating sequence over a radix-cached prefix never writes the shared
  blocks; random workloads (fixed seeds) conserve blocks and match
  ``spec_steps=0``;
* chunked prefill with speculation; ``step_token_budget`` defers
  admission; ``REPRO_SPEC_STEPS`` is the default depth;
* rejections: no MTP head, a sampled request, a depth past the unshared
  layers, a negative depth, the hybrid family (a partial accept cannot
  roll its recurrent state back: ``ValueError``, as the reference).

``AgentSession`` turns with speculation come with the session slice
(ROADMAP).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DSAConfig as JaxDSAConfig
from repro.configs.base import MTPConfig as JaxMTPConfig
from repro.core.mtp import speculative_accept_length as jax_accept
from repro.models import get_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import speculative as jspec
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.configs.base import MTPConfig
from repro_torch.core.mtp import speculative_accept_length
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousEngine, Request
from repro_torch.serving import speculative as tspec
from _torch_threads import one_torch_thread  # noqa: F401

_KW = dict(max_batch=2, block_size=8, num_blocks=32, max_len=64)
_MTP = JaxMTPConfig(num_predict=3, share_params=True)


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _family_cfg(name):
    if name in ("gqa", "dsa"):
        return get_smoke_config("yi_6b").replace(
            d_model=128, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, mtp=_MTP,
            dsa=JaxDSAConfig(index_heads=2, index_head_dim=16, top_k=32,
                             block_size=16) if name == "dsa" else None)
    if name == "mla":
        return get_smoke_config("glm5_744b").replace(
            d_model=128, num_heads=2, num_kv_heads=2, d_ff=256,
            vocab_size=256, num_experts=0, num_shared_experts=0, mtp=_MTP,
            first_k_dense=1)
    return get_smoke_config("glm5_744b").replace(moe_impl="dense")  # glm5


@functools.lru_cache(maxsize=None)
def _family(name):
    """(JAX cfg, JAX params, the port's model with the same weights)."""
    jcfg = _family_cfg(name)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    return jcfg, params, model


def _workload(vocab):
    """4 requests with staggered prompt lengths and budgets through a
    2-slot engine: admissions and retirements interleave."""
    rng = np.random.default_rng(3)
    return [(rng.integers(3, vocab, size=k).astype(np.int32), m)
            for k, m in zip((11, 5, 17, 7), (6, 9, 3, 7))]


def _serve(make_engine, make_request, vocab, spec):
    eng = make_engine(spec)
    reqs = [make_request(p, m) for p, m in _workload(vocab)]
    eng.serve(reqs)
    # radix-suffix admission: the first prompt extended (the match ends
    # mid-block: a COW fork)
    suffix = make_request(np.concatenate([reqs[0].prompt,
                                          np.asarray([7, 9, 11], np.int32)]),
                          5)
    eng.serve([suffix])
    return [r.out for r in reqs + [suffix]], eng


def _port_serve(name, spec, **kw):
    jcfg, _, model = _family(name)
    return _serve(lambda n: ContinuousEngine(model.cfg, model, spec_steps=n,
                                             device="cpu", **_KW, **kw),
                  lambda p, m: Request(prompt=p, max_new=m),
                  jcfg.vocab_size, spec)


@functools.lru_cache(maxsize=None)
def _jax_serve(name, spec):
    jcfg, params, _ = _family(name)
    outs, eng = _serve(lambda n: JaxEngine(jcfg, params, spec_steps=n,
                                           **_KW),
                       lambda p, m: JaxRequest(prompt=p, max_new=m),
                       jcfg.vocab_size, spec)
    return outs, {k: eng.stats[k] for k in ("draft_tokens",
                                            "accepted_tokens", "spec_rounds")}


@functools.lru_cache(maxsize=None)
def _port_oracle(name):
    return _port_serve(name, 0)[0]


# ---------------------------------------------------------------------------
# greedy tokens, spec on vs off, port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["gqa", "dsa", "mla"])
@pytest.mark.parametrize("spec", [2, 4])
def test_engine_spec_greedy_byte_identical(family, spec):
    outs, eng = _port_serve(family, spec)
    for a, b in zip(_port_oracle(family), outs):
        np.testing.assert_array_equal(a, b)
    st = eng.stats
    assert st["spec_rounds"] > 0 and st["draft_tokens"] > 0
    assert st["spec_rounds"] <= st["accepted_tokens"] \
        <= st["draft_tokens"] + st["spec_rounds"]
    assert 1.0 <= eng.rolling_accept_length <= spec + 1
    assert eng.table_width == eng.max_blocks + -(-spec // 8)


@pytest.mark.parametrize("family,spec", [("gqa", 4), ("dsa", 2), ("mla", 4),
                                         ("glm5", 3)])
def test_engine_spec_matches_jax_engine(family, spec):
    """The port's speculative engine against JAX's at the same depth:
    tokens, and the drafted / accepted counts (the drafts are the same)."""
    outs, eng = _port_serve(family, spec)
    want, want_stats = _jax_serve(family, spec)
    for a, b in zip(outs, want):
        np.testing.assert_array_equal(a, b)
    assert {k: eng.stats[k] for k in want_stats} == want_stats


def test_mtp_draft_and_verify_step_match_jax():
    """One speculative round's two halves on GLM-5 smoke (MLA + DSA + MoE,
    its MTP head's block carries an indexer it does not use): the drafts
    from a trunk state, then the span [pending, drafts] at per-row starts
    over a paged pool that already holds the prompts."""
    jcfg, params, model = _family("glm5")
    jm = get_model(jcfg)
    rng = np.random.default_rng(4)
    B, P, bs, mb = 2, 21, 8, 6
    prompts = rng.integers(3, jcfg.vocab_size, (B, P)).astype(np.int32)
    tables = np.arange(B * mb, dtype=np.int32).reshape(B, mb)
    jpool, _ = jm.init_paged_cache(jcfg, B * mb + 1, bs)
    tpool = T.init_paged_cache(model.cfg, B * mb + 1, bs, device="cpu")
    zeros = np.zeros((B,), np.int32)
    jl, jh, jpool = jm.verify_step(params, jnp.asarray(prompts), jcfg, jpool,
                                   jnp.asarray(zeros),
                                   block_tables=jnp.asarray(tables))
    tl, th, tpool = T.verify_step(model, torch.from_numpy(prompts), tpool,
                                  torch.from_numpy(zeros),
                                  block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    pos = np.full((B, 1), P - 1, np.int32)
    want = jspec.mtp_draft(params, jcfg, jh[:, -1:], jnp.asarray(nxt),
                           jnp.asarray(pos), 3)
    got = tspec.mtp_draft(model, th[:, -1:], torch.from_numpy(nxt),
                          torch.from_numpy(pos), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    span = np.concatenate([nxt, np.asarray(want, np.int32)], 1)
    lens = np.full((B,), P, np.int32)
    jl, jh, _ = jm.verify_step(params, jnp.asarray(span), jcfg, jpool,
                               jnp.asarray(lens),
                               block_tables=jnp.asarray(tables))
    tl, th, _ = T.verify_step(model, torch.from_numpy(span), tpool,
                              torch.from_numpy(lens),
                              block_tables=torch.from_numpy(tables))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


def test_engine_spec_composes_with_chunked_prefill():
    jcfg, _, model = _family("gqa")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, jcfg.vocab_size, size=k).astype(np.int32)
               for k in (19, 11)]

    def serve(spec, chunk):
        eng = ContinuousEngine(model.cfg, model, spec_steps=spec,
                               prefill_chunk=chunk, device="cpu", **_KW)
        reqs = [Request(prompt=p, max_new=6) for p in prompts]
        eng.serve(reqs)
        return [r.out for r in reqs]

    for a, b in zip(serve(0, None), serve(4, 8)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# rejections
# ---------------------------------------------------------------------------

def test_spec_rejections():
    jcfg, _, model = _family("gqa")
    cfg = model.cfg
    with pytest.raises(ValueError, match="MTP"):
        ContinuousEngine(cfg.replace(mtp=None), model, spec_steps=2,
                         device="cpu", **_KW)
    with pytest.raises(ValueError, match="share_params"):
        ContinuousEngine(cfg.replace(mtp=MTPConfig(num_predict=2,
                                                   share_params=False)),
                         model, spec_steps=4, device="cpu", **_KW)
    with pytest.raises(ValueError, match=">= 0"):
        ContinuousEngine(cfg, model, spec_steps=-1, device="cpu", **_KW)
    with pytest.raises(ValueError, match="hybrid"):
        ContinuousEngine(cfg.replace(family="hybrid"), model, spec_steps=2,
                         device="cpu", **_KW)
    eng = ContinuousEngine(cfg, model, spec_steps=2, device="cpu", **_KW)
    with pytest.raises(ValueError, match="greedy"):
        eng.submit(Request(prompt=np.asarray([5, 6], np.int32), max_new=2,
                           temperature=0.7))


def test_spec_steps_env_default(monkeypatch):
    jcfg, _, model = _family("gqa")
    monkeypatch.setenv("REPRO_SPEC_STEPS", "3")
    assert ContinuousEngine(model.cfg, model, device="cpu",
                            **_KW).spec_steps == 3
    assert ContinuousEngine(model.cfg, model, spec_steps=0, device="cpu",
                            **_KW).spec_steps == 0


# ---------------------------------------------------------------------------
# accept-length semantics
# ---------------------------------------------------------------------------

def test_accept_length_unit_properties():
    v = np.asarray([[4, 5, 6, 7]] * 4)
    drafts = np.asarray([[4, 5, 6, 7], [9, 5, 6, 7], [4, 5, 9, 7],
                         [4, 5, 6, 9]])
    got = speculative_accept_length(torch.from_numpy(drafts),
                                    torch.from_numpy(v))
    np.testing.assert_array_equal(got.numpy(), [5, 1, 3, 4])
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_accept(jnp.asarray(drafts),
                                           jnp.asarray(v))))


def test_measure_paged_matches_ref_oracle_and_jax():
    """The O(n)-a-round paged verification reproduces the full re-run
    oracle (accept lengths and spliced tokens), on both routes, and both
    equal JAX's measurement."""
    jcfg, params, model = _family("gqa")
    prompts = np.random.default_rng(2).integers(3, jcfg.vocab_size, (2, 12))
    want = jspec.measure_accept_length(params, jcfg,
                                       jnp.asarray(prompts, jnp.int32),
                                       n_steps=2, impl="paged")
    tp = torch.from_numpy(prompts.astype(np.int32))
    ref = tspec.measure_accept_length(model, tp, n_steps=2, impl="ref")
    for attn_impl in ("kernel", "ref"):
        pag = tspec.measure_accept_length(model, tp, n_steps=2,
                                          attn_impl=attn_impl)
        assert pag["accept_length"] == pytest.approx(ref["accept_length"])
        np.testing.assert_array_equal(pag["tokens"], ref["tokens"])
    assert ref["accept_length"] == pytest.approx(want["accept_length"])
    np.testing.assert_array_equal(ref["tokens"], want["tokens"])
    assert 1.0 <= ref["accept_length"] <= 1 + jcfg.mtp.num_predict


# ---------------------------------------------------------------------------
# rollback invariants
# ---------------------------------------------------------------------------

def _check_conservation(eng):
    kv = eng.kv
    assert kv.free_blocks + kv.used_blocks == kv.num_blocks
    assert len(set(kv._free)) == kv.free_blocks          # no double free
    assert all(c >= 1 for c in kv._ref.values())         # no zombie refs


def test_spec_rollback_across_block_boundary():
    """The first round of a 7-token prompt (block size 8) writes positions
    7..11 across the block-0/1 boundary; the rollback truncates to the
    accept point and no block changes hands."""
    jcfg, _, model = _family("gqa")
    eng = ContinuousEngine(model.cfg, model, spec_steps=4,
                           prefix_cache=False, device="cpu", **_KW)
    rng = np.random.default_rng(11)
    req = Request(prompt=rng.integers(3, jcfg.vocab_size, size=7)
                  .astype(np.int32), max_new=8)
    eng.submit(req)
    eng.step()                               # admit + prefill + spec round
    slot = next(i for i, s in enumerate(eng.slots) if s is not None)
    acc = eng.stats["accepted_tokens"]
    assert 1 <= acc <= 5
    assert eng.lengths[slot] == 7 + acc      # truncated to the accept point
    used = eng.kv.used_blocks
    _check_conservation(eng)
    while eng.busy:
        eng.step()
        assert eng.kv.used_blocks <= used    # rollbacks never allocate
        _check_conservation(eng)
    e0 = ContinuousEngine(model.cfg, model, spec_steps=0, prefix_cache=False,
                          device="cpu", **_KW)
    ref = Request(prompt=req.prompt.copy(), max_new=8)
    e0.serve([ref])
    np.testing.assert_array_equal(ref.out, req.out)


def _block_rows(eng, block):
    """Every pool row holding ``block`` (all layers), concatenated."""
    stride = eng.kv.num_blocks + 1
    rows = []
    for leaves in eng.pool.values():
        for leaf in leaves.values():
            base = np.arange(leaf.shape[0] // stride) * stride
            rows.append(leaf[base + block].numpy().ravel())
    return np.concatenate(rows)


def test_spec_rollback_on_cow_fork_preserves_shared_blocks():
    jcfg, _, model = _family("gqa")
    eng = ContinuousEngine(model.cfg, model, spec_steps=3, device="cpu",
                           **_KW)
    rng = np.random.default_rng(13)
    shared = rng.integers(3, jcfg.vocab_size, size=11).astype(np.int32)
    eng.serve([Request(prompt=shared, max_new=4)])
    m, mblocks = eng.prefix.match(list(map(int, shared)))
    assert m >= 8 and mblocks
    snaps = {b: _block_rows(eng, b).copy() for b in mblocks[:m // 8]}
    eng.kv.release(mblocks)                  # undo the probe's retain
    eng.serve([Request(prompt=np.concatenate(
        [shared, np.asarray([5, 6, 7], np.int32)]), max_new=6)])
    assert eng.stats["cow_forks"] >= 1
    for b, before in snaps.items():
        np.testing.assert_array_equal(_block_rows(eng, b), before)
    _check_conservation(eng)


@pytest.mark.parametrize("seed,sizes,share", [
    (1, ((3, 4), (17, 9), (8, 1)), True),
    (2, ((20, 10), (1, 3)), False),
    (3, ((9, 7), (12, 2), (5, 10), (14, 6)), True)])
def test_spec_workloads_conserve_blocks_and_match_oracle(seed, sizes, share):
    """Random prompts, optionally on a shared prefix, staggered budgets,
    served twice (the second pass admits over the first's cached
    prefixes): the allocator stays conserved and the tokens equal
    ``spec_steps=0``'s."""
    jcfg, _, model = _family("gqa")
    eng = ContinuousEngine(model.cfg, model, spec_steps=3, device="cpu",
                           **_KW)
    oracle = ContinuousEngine(model.cfg, model, spec_steps=0, device="cpu",
                              **_KW)
    rng = np.random.default_rng(seed)
    base = rng.integers(3, jcfg.vocab_size, size=9).astype(np.int32)
    prompts = [np.concatenate([base, rng.integers(3, jcfg.vocab_size,
                                                  size=n)]).astype(np.int32)
               if share else rng.integers(3, jcfg.vocab_size, size=n)
               .astype(np.int32) for n, _ in sizes]
    for _ in range(2):
        reqs = [Request(prompt=p.copy(), max_new=m)
                for p, (_, m) in zip(prompts, sizes)]
        refs = [Request(prompt=p.copy(), max_new=m)
                for p, (_, m) in zip(prompts, sizes)]
        eng.serve(reqs)
        _check_conservation(eng)
        oracle.serve(refs)
        for a, b in zip(refs, reqs):
            np.testing.assert_array_equal(a.out, b.out)


def test_step_token_budget_defers_admission():
    """A budget of 5 tokens a step with spec 4 (5 a slot until an accept
    length is measured) admits one slot at a time; the tokens do not
    change."""
    jcfg, _, model = _family("gqa")
    eng = ContinuousEngine(model.cfg, model, spec_steps=4,
                           step_token_budget=5, device="cpu", **_KW)
    reqs = [Request(prompt=p, max_new=m) for p, m in _workload(256)]
    eng.serve(reqs)
    assert eng.stats["budget_deferrals"] > 0
    for r, want in zip(reqs, _port_oracle("gqa")):
        np.testing.assert_array_equal(r.out, want)
    with pytest.raises(ValueError, match="step_token_budget"):
        ContinuousEngine(model.cfg, model, step_token_budget=0,
                         device="cpu", **_KW)
