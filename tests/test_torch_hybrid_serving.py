"""PyTorch port, the hybrid family in the continuous-batching engine against
the JAX package.

zamba2's smoke config cut as the reference's serving tests cut it
(d_model 128, 2 heads of 32, N 8, vocab 256; 4 Mamba-2 layers and two
invocations of the shared block), weights carried over with
``bridge.from_jax_params``, fp32:

* the port's ``ContinuousEngine`` (2 slots for 4 requests, so slots are
  reused and each admission zeroes its slot's Mamba-2 state) gives the
  greedy tokens of JAX's ``ServingEngine`` oracle and of the port's own
  static engine, with whole-prompt and chunked (8) prefill, with
  ``dsa=None`` and with DSA; the prefix cache is forced off and every block
  comes back (``tests/test_prefix_cache.py``'s hybrid case); each token's
  top-2 margin under teacher forcing is asserted, so equal tokens are not
  a near-tie's luck;
* ``attn_impl="ref"`` (the gather oracle) and the in-place route give the
  same greedy tokens (``tests/test_paged_attention.py``'s hybrid case);
* speculation is refused with a ``ValueError`` naming the family
  (``tests/test_speculative.py``'s guard).
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model as jax_get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.models import hybrid
from repro_torch.serving import ContinuousEngine, Request, ServingEngine

PLENS, MAXNEW = [5, 17, 9, 12], [3, 6, 4, 5]
MARGIN = 1e-4
KW = dict(max_batch=2, block_size=8, num_blocks=24, max_len=64,
          device="cpu")


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@functools.lru_cache(maxsize=None)
def _setup(dsa: bool):
    jcfg = get_smoke_config("zamba2_2p7b").replace(
        d_model=128, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256, ssm_state=8)
    if not dsa:
        jcfg = jcfg.replace(dsa=None)
    params, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_cfg(jcfg), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in PLENS]
    oracle = [JaxRequest(prompt=p, max_new=m)
              for p, m in zip(prompts, MAXNEW)]
    JaxOracle(jcfg, params, max_batch=1, max_len=64).serve(oracle)
    return model, prompts, [np.asarray(r.out) for r in oracle]


def _serve(engine, prompts):
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, MAXNEW)]
    engine.serve(reqs)
    return [r.out for r in reqs]


def _min_margin(model, prompt, out) -> float:
    """The smallest top-2 logit margin over the positions that chose
    ``out`` (teacher-forced through the whole model)."""
    seq = np.concatenate([prompt, out[:-1]])[None]
    lg = hybrid.logits(model, torch.from_numpy(seq))[0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    return float((top2[:, 0] - top2[:, 1]).min())


@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("dsa", [False, True], ids=["dense", "dsa"])
def test_continuous_engine_matches_oracles(dsa, chunk):
    model, prompts, want = _setup(dsa)
    eng = ContinuousEngine(model.cfg, model, prefill_chunk=chunk, **KW)
    assert eng.prefix is None      # recurrent state cannot be re-aliased
    got = _serve(eng, prompts)
    static = _serve(ServingEngine(model.cfg, model, max_batch=1, max_len=64,
                                  device="cpu"), prompts)
    for p, g, s, w in zip(prompts, got, static, want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(s, w)
        assert _min_margin(model, p, w) >= MARGIN
    # 4 requests through 2 slots: slot REUSE (and so the state reset on
    # admission) happened mid-flight
    assert any(s > 0 for s in eng.stats["admit_steps"])
    assert eng.kv.free_blocks == eng.kv.num_blocks
    if chunk:
        assert eng.stats["chunk_steps"] > len(prompts)


def test_gather_oracle_matches_in_place_route():
    model, prompts, _ = _setup(False)
    ref = ContinuousEngine(model.cfg, model, attn_impl="ref", **KW)
    pal = ContinuousEngine(model.cfg, model, **KW)
    for a, b in zip(_serve(ref, prompts), _serve(pal, prompts)):
        np.testing.assert_array_equal(a, b)
    assert pal.stats["gather_bytes_saved"] > 0
    assert ref.stats["gather_bytes_saved"] == 0
    assert pal.stats["prefill_gather_bytes_saved"] > 0
    assert ref.stats["prefill_gather_bytes_saved"] == 0


def test_pool_state_per_slot_and_bytes():
    model, _, _ = _setup(True)
    cfg = model.cfg
    eng = ContinuousEngine(cfg, model, **KW)
    ssm = eng.pool["ssm"]
    assert ssm["ssm"].shape[:2] == (cfg.num_layers, KW["max_batch"])
    # a token's bytes: the shared block's k, v and k_idx in each of its
    # invocations; the per-slot state is not counted
    per_token = hybrid.n_groups(cfg) * 4 * (
        2 * cfg.num_kv_heads * cfg.head_dim + cfg.dsa.index_head_dim)
    assert eng._token_bytes == per_token


def test_spec_refused_for_hybrid():
    model, _, _ = _setup(False)
    with pytest.raises(ValueError, match="hybrid"):
        ContinuousEngine(model.cfg, model, spec_steps=2, **KW)
