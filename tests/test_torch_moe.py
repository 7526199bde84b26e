"""PyTorch port, MoE: ``layers/moe.py`` against the JAX package.

* ``router_topk`` gives the reference's expert ids (in rank order), gates
  and auxiliary loss, including exact ties between experts, where
  ``jax.lax.top_k`` ranks the lower id first.
* ``apply_moe`` (routed: only the chosen (token, expert) pairs are
  computed) plus the shared expert equals the reference's all-experts
  oracle ``cfg.replace(moe_impl="dense")`` at rtol 1e-5 of the output's
  scale (|got - want| <= 1e-5 * max|want|: at the reference's init the
  outputs reach a few hundred and some elements are sums of large terms
  that cancel, where an elementwise rtol measures fp32 rounding of the
  terms, not the port), in fp32, for the GLM-5 smoke geometry and a
  16-expert top-4 variant where some experts get no token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.layers import moe as jmoe
from repro.sharding.rules import Builder
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.layers import moe as tmoe

RTOL, ATOL = 1e-5, 1e-6


def _close_to_scale(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


def _cfgs(name):
    jcfg = get_smoke_config("glm5_744b").replace(dsa=None, mtp=None,
                                                 moe_impl="dense")
    if name == "e16_top4":
        jcfg = jcfg.replace(num_experts=16, experts_per_token=4,
                            num_shared_experts=2, moe_d_ff=32)
    pcfg = PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})
    return jcfg, pcfg


def _params(jcfg, pcfg, seed=0):
    b = Builder(jax.random.key(seed), jnp.float32)
    jmoe.build_moe(b, jcfg)
    module = tmoe.MoE(pcfg, device="cpu", dtype=torch.float32)
    module.load_state_dict({k: torch.tensor(np.asarray(v))
                            for k, v in b.params.items()}, strict=True)
    return b.params, module


@pytest.mark.parametrize("name", ["glm5_smoke", "e16_top4"])
def test_router_topk_matches_jax(name):
    jcfg, pcfg = _cfgs(name)
    jp, tp = _params(jcfg, pcfg)
    x = np.random.default_rng(0).standard_normal(
        (37, jcfg.d_model)).astype(np.float32)
    g_j, i_j, a_j = jmoe.router_topk(jp, jnp.asarray(x), jcfg)
    g_t, i_t, a_t = tmoe.router_topk(tp, torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(a_t.item(), float(a_j), rtol=RTOL)


def test_router_breaks_exact_ties_by_lower_expert_id():
    jcfg, pcfg = _cfgs("e16_top4")
    jp, tp = _params(jcfg, pcfg)
    # equal router columns give bit-equal probabilities: experts 3, 5, 6
    # and 9 tie for every token, experts 0 and 1 tie as well
    w = np.asarray(jp["router"]).copy()
    w[:, 5] = w[:, 6] = w[:, 9] = w[:, 3] * 1.0
    w[:, 1] = w[:, 0]
    jp = dict(jp, router=jnp.asarray(w))
    tp.router.data = torch.from_numpy(w)
    x = np.random.default_rng(1).standard_normal(
        (64, jcfg.d_model)).astype(np.float32)
    # and one token for which the tied experts lead by far: the first
    # two ranks and the k boundary all fall inside ties
    x[0] = w[:, 3] / np.linalg.norm(w[:, 3]) * 50.0
    g_j, i_j, _ = jmoe.router_topk(jp, jnp.asarray(x), jcfg)
    g_t, i_t, _ = tmoe.router_topk(tp, torch.from_numpy(x), pcfg)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    assert i_t[0].tolist() == [3, 5, 6, 9]
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["glm5_smoke", "e16_top4"])
@pytest.mark.parametrize("shape", [(3, 7), (1, 2)])
def test_apply_moe_matches_jax_dense_oracle(name, shape, monkeypatch):
    jcfg, pcfg = _cfgs(name)
    jp, tp = _params(jcfg, pcfg, seed=2)
    x = np.random.default_rng(2).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    calls = []
    ffn = tmoe._expert_ffn
    monkeypatch.setattr(tmoe, "_expert_ffn",
                        lambda *a: calls.append(a[3].shape[0]) or ffn(*a))
    y_j, aux_j = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    y_t, aux_t = tmoe.apply_moe(tp, torch.from_numpy(x), pcfg)
    assert y_t.shape == x.shape
    _close_to_scale(y_t.numpy(), y_j)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=RTOL)
    # routed: each chosen expert runs once, on exactly its tokens
    _, idx, _ = tmoe.router_topk(
        tp, torch.from_numpy(x).reshape(-1, jcfg.d_model), pcfg)
    assert len(calls) == len(set(idx.reshape(-1).tolist()))
    assert sum(calls) == idx.numel()
