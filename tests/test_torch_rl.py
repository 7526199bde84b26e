"""PyTorch port, the RL objectives (``repro_torch.rl``) on the CPU.

Mirrors ``tests/test_rl.py`` test for test on the port (the ``@given``
``pad_or_drop_group`` property with the reference's ``max_examples``), then
holds the port against the JAX package on the same numpy-seeded fp32
inputs:

* ``grpo_icepop_loss``, ``async_is_loss`` and ``onpolicy_distill_loss``:
  every statistic and the gradient of the loss with respect to the
  differentiated logprobs (torch autograd against ``jax.grad``), rtol
  1e-6 (atol 1e-7 for entries at 0), with tokens on both sides of every
  mask's edges;
* ``group_advantages``: the population std (ddof 0, ``jnp.std``'s), also
  on a group of two where ddof 1 would differ by sqrt(2);
* ``pad_or_drop_group``: the replication counts equal to the reference's
  for every group of up to 9 and for ties in the stable order;
* ``calibration_mask``, ``pop_mask``, ``staleness_keep``;
* the rewards: equal to the reference's on the same tokens.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, strategies as st

from repro.rl import async_is as jis
from repro.rl import distill as jdist
from repro.rl import grpo as jgrpo
from repro.rl import rewards as jrew
from repro_torch.rl import rewards
from repro_torch.rl.async_is import (async_is_loss, calibration_mask,
                                     pad_or_drop_group, staleness_keep)
from repro_torch.rl.distill import onpolicy_distill_loss
from repro_torch.rl.grpo import group_advantages, grpo_icepop_loss, pop_mask

RTOL = 1e-6
_jax_pad = jax.jit(jis.pad_or_drop_group)     # one compile a group size


def _t(x):
    return torch.tensor(np.asarray(x))


# ---------------------------------------------------------------------------
# mirrors of tests/test_rl.py
# ---------------------------------------------------------------------------

def test_pop_mask_bounds():
    rho = _t(np.array([0.1, 0.5, 1.0, 2.0, 2.01, 10.0], np.float32))
    m = pop_mask(rho, beta=2.0)
    np.testing.assert_array_equal(m.numpy(), [0, 1, 1, 1, 0, 0])


def test_group_advantages_zero_mean_unit_std():
    r = torch.randn(8, 32, generator=torch.Generator().manual_seed(0)) * 3 + 1
    a = group_advantages(r)
    np.testing.assert_allclose(a.mean(1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(a.std(1, correction=0).numpy(), 1.0,
                               atol=1e-3)


def test_grpo_gradient_direction():
    """Positive-advantage tokens must have their logprob pushed UP."""
    B, T = 4, 8
    logp = torch.full((B, T), -1.0, requires_grad=True)
    adv = torch.tensor([1.0, 1.0, -1.0, -1.0])
    mask = torch.ones((B, T))
    grpo_icepop_loss(logp, logp.detach(), logp.detach(), adv,
                     mask).loss.backward()
    g = logp.grad
    assert bool((g[:2] < 0).all())     # minimizing loss raises logp
    assert bool((g[2:] > 0).all())


def test_icepop_masks_mismatched_tokens():
    B, T = 2, 6
    logp = torch.zeros((B, T))
    logp_infer = torch.zeros((B, T))
    logp_infer[0, 0] = -5.0                          # huge mismatch
    st_ = grpo_icepop_loss(logp, logp, logp_infer, torch.ones(B),
                           torch.ones((B, T)))
    assert float(st_.kept_frac) == pytest.approx(11 / 12)


def test_async_is_stop_gradient_structure():
    """Gradient must flow ONLY through logπ_θ; masked tokens contribute 0."""
    B, T = 2, 4
    lp = torch.zeros((B, T))
    lp[0, 0] = 1.0                      # ratio e^1 > 1.2 -> masked
    lp.requires_grad_(True)
    async_is_loss(lp, torch.zeros((B, T)), torch.ones(B),
                  torch.ones((B, T))).loss.backward()
    assert float(lp.grad[0, 0]) == 0.0
    assert float(lp.grad[0, 1]) != 0.0


def test_distill_advantage_sign():
    """Tokens where teacher >> student get positive advantage (pushed up)."""
    B, T = 1, 4
    lp_s = torch.full((B, T), -2.0, requires_grad=True)
    lp_t = torch.tensor([[-0.5, -2.0, -4.0, -2.0]])
    onpolicy_distill_loss(lp_s, lp_t, lp_s.detach(),
                          torch.ones((B, T))).loss.backward()
    assert float(lp_s.grad[0, 0]) < 0      # teacher better -> raise
    assert float(lp_s.grad[0, 2]) > 0      # teacher worse -> lower


def test_staleness():
    keep = staleness_keep(torch.tensor([0, 3, 7, 9]), current_version=10,
                          tau=4)
    np.testing.assert_array_equal(keep.numpy(), [False, False, True, True])


@settings(max_examples=100, deadline=None)
@given(st.lists(st.booleans(), min_size=2, max_size=16))
def test_pad_or_drop_group_properties(valid_list):
    valid = torch.tensor(valid_list)
    counts = pad_or_drop_group(valid)
    G = len(valid_list)
    n_valid = sum(valid_list)
    if n_valid > G // 2:
        assert int(counts.sum()) == G           # padded back to full group
        assert bool(((counts == 0) | valid).all())  # only valid replicated
    else:
        assert int(counts.sum()) == 0           # whole group dropped
    # and the counts are the reference's, element for element
    np.testing.assert_array_equal(
        counts.numpy(), np.asarray(_jax_pad(jnp.asarray(valid_list))))


def test_calibration_mask_double_sided():
    r = _t(np.array([0.5, 0.81, 1.0, 1.19, 1.3], np.float32))
    m = calibration_mask(r, 0.2, 0.2)
    np.testing.assert_array_equal(m.numpy(), [0, 1, 1, 1, 0])


# ---------------------------------------------------------------------------
# values and gradients against the JAX package
# ---------------------------------------------------------------------------

def _inputs(seed, B=6, T=24):
    """fp32 logprobs whose ratios straddle every gate's edges, advantages of
    both signs, a ragged mask."""
    rng = np.random.default_rng(seed)
    lp = (-rng.random((B, T)) * 4 - 0.05).astype(np.float32)
    shift = rng.choice([-1.5, -0.3, -0.1, 0.0, 0.1, 0.25, 0.9],
                       size=(B, T)).astype(np.float32)
    old = (lp - shift).astype(np.float32)
    infer = (old - rng.choice([-1.0, -0.2, 0.0, 0.3, 1.2], size=(B, T))
             ).astype(np.float32)
    adv = rng.standard_normal(B).astype(np.float32)
    lens = rng.integers(1, T + 1, size=B)
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
    return lp, old, infer, adv, mask


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-7)


def _torch_value_and_grad(fn, lp, *rest):
    x = torch.tensor(lp, requires_grad=True)
    stats = fn(x, *[torch.tensor(r) for r in rest])
    stats.loss.backward()
    return stats, x.grad.numpy()


def _jax_value_and_grad(fn, lp, *rest):
    (_, stats), g = jax.value_and_grad(
        lambda x: (fn(x, *rest).loss, fn(x, *rest)), has_aux=True)(
            jnp.asarray(lp))
    return stats, np.asarray(g)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grpo_icepop_loss_matches_jax(seed):
    lp, old, infer, adv, mask = _inputs(seed)
    kw = dict(beta=2.0, eps_low=0.2, eps_high=0.28)
    ts, tg = _torch_value_and_grad(
        lambda x, o, i, a, m: grpo_icepop_loss(x, o, i, a, m, **kw),
        lp, old, infer, adv, mask)
    js, jg = _jax_value_and_grad(
        lambda x, o, i, a, m: jgrpo.grpo_icepop_loss(x, o, i, a, m, **kw),
        lp, old, infer, adv, mask)
    assert 0.0 < float(js.kept_frac) < 1.0 and float(js.clip_frac) > 0
    for name in ts._fields:
        _close(float(getattr(ts, name).detach()), float(getattr(js, name)))
    assert np.abs(jg).max() > 0
    _close(tg, jg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_async_is_loss_matches_jax(seed):
    lp, _, infer, adv, mask = _inputs(seed)
    ts, tg = _torch_value_and_grad(async_is_loss, lp, infer, adv, mask)
    js, jg = _jax_value_and_grad(jis.async_is_loss, lp, infer, adv, mask)
    assert 0.0 < float(js.kept_frac) < 1.0
    for name in ts._fields:
        _close(float(getattr(ts, name).detach()), float(getattr(js, name)))
    assert (jg == 0).any() and (jg != 0).any()     # masked and kept tokens
    _close(tg, jg)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_onpolicy_distill_loss_matches_jax(seed):
    lp, teacher, infer, _, mask = _inputs(seed)
    ts, tg = _torch_value_and_grad(onpolicy_distill_loss, lp, teacher,
                                   infer, mask)
    js, jg = _jax_value_and_grad(jdist.onpolicy_distill_loss, lp, teacher,
                                 infer, mask)
    for name in ts._fields:
        _close(float(getattr(ts, name).detach()), float(getattr(js, name)))
    _close(tg, jg)


def test_group_advantages_population_std_matches_jax():
    rng = np.random.default_rng(3)
    for shape in ((4, 8), (3, 2), (2, 16)):
        r = rng.standard_normal(shape).astype(np.float32) * 2
        r[0, :] = 1.0                                 # a constant group
        _close(group_advantages(_t(r)).numpy(),
               np.asarray(jgrpo.group_advantages(jnp.asarray(r))))
    # a group of two: ddof 0 gives (+-1) / (1 + eps), ddof 1 +-1/sqrt(2)
    a = group_advantages(torch.tensor([[0.0, 1.0]]))
    np.testing.assert_allclose(a.numpy(), [[-1.0, 1.0]], rtol=1e-5)


def test_pad_or_drop_group_matches_jax_with_ties():
    """Every validity pattern of up to 9 samples: the stable order puts the
    extra copies on the first valid samples by index, as ``jnp.argsort``."""
    for G in range(2, 10):
        for bits in itertools.product([False, True], repeat=G):
            got = pad_or_drop_group(torch.tensor(bits)).numpy()
            want = np.asarray(_jax_pad(jnp.asarray(bits)))
            np.testing.assert_array_equal(got, want, err_msg=str(bits))


def test_masks_and_staleness_match_jax():
    rng = np.random.default_rng(4)
    r = rng.uniform(0.3, 2.5, size=64).astype(np.float32)
    r[:6] = [0.8, 1.2, 0.5, 2.0, 1.0 / 2.0, 2.0]     # the edges themselves
    np.testing.assert_array_equal(
        calibration_mask(_t(r), 0.2, 0.2).numpy(),
        np.asarray(jis.calibration_mask(jnp.asarray(r), 0.2, 0.2)))
    np.testing.assert_array_equal(
        pop_mask(_t(r), 2.0).numpy(),
        np.asarray(jgrpo.pop_mask(jnp.asarray(r), 2.0)))
    vmin = rng.integers(0, 12, size=16)
    np.testing.assert_array_equal(
        staleness_keep(_t(vmin), 10, 4).numpy(),
        np.asarray(jis.staleness_keep(jnp.asarray(vmin), 10, 4)))


def test_rewards_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(50):
        tgt = rng.integers(0, 6, size=rng.integers(0, 6))
        gen = rng.integers(0, 6, size=rng.integers(0, 8))
        assert rewards.prefix_reward(gen, tgt) == jrew.prefix_reward(gen,
                                                                     tgt)
        assert rewards.exact_match_reward(gen, tgt) == \
            jrew.exact_match_reward(gen, tgt)
