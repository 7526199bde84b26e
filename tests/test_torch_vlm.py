"""PyTorch port: the VLM family (phi-3-vision, its smoke config with the
DSA retrofit and 16 patch embeddings) against the JAX package.

The reference's weights are carried over by ``from_jax_params``; the patch
embeddings are ``0.01 · N(0, 1)`` from a numpy seed, as
``tests/test_models.py`` makes them, put before the text (positions run
over F + S; 16 + 112 = 128 rows, past the indexer's top-k of 64):

* logits without a cache against the reference's ``logits`` with
  ``frontend_embeds``, fp32 rtol 1e-4;
* the loss (the cross-entropy over the text rows only, plus 0.01 × the
  indexer KL) and every gradient against ``jax.value_and_grad`` of the
  reference's ``loss``: the loss within rtol 1e-5, every gradient within
  rtol 1e-4 and 1e-5 of its leaf's max, the indexer weights' within 5e-3
  (``test_torch_train``'s rule: their only gradient is the KL over each
  query's top-k set, which a near-tie can move);
* ``launch.steps.make_prefill_step`` with the patches against the
  reference's, and ``prefill`` of the patches and a prompt into a
  contiguous cache, then a decode step, against JAX's and against the
  port's own forward;
* the port's ``ContinuousEngine`` on text-only requests (as the
  reference's engine serves this family) against JAX's static
  ``ServingEngine``: greedy tokens equal wherever every generated
  position's top-2 logit margin is >= 1e-3.

One JAX oracle a module: the reference's weights, logits and gradients
are made once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import get_model
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousEngine, Request
from test_torch_dsa import MARGIN, port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

B, S = 2, 112


def _close(got, want, rtol=1e-4, atol=1e-5):
    """rtol, and atol as a share of max |want|."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def pair():
    jcfg = get_smoke_config("phi3_vision_4b")
    assert jcfg.family == "vlm" and jcfg.dsa is not None
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    fe = (0.01 * rng.standard_normal((B, jcfg.frontend_tokens,
                                      jcfg.d_model))).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32),
             "frontend_embeds": fe}
    return jcfg, params, params_np, model, batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_logits_with_patches_match_jax(pair):
    jcfg, params, _, model, batch = pair
    want = get_model(jcfg).logits(params, jnp.asarray(batch["tokens"]), jcfg,
                                  frontend_embeds=jnp.asarray(
                                      batch["frontend_embeds"]))
    with torch.no_grad():
        got = T.logits(model, torch.from_numpy(batch["tokens"]),
                       frontend_embeds=torch.from_numpy(
                           batch["frontend_embeds"]))
    assert got.shape == (B, jcfg.frontend_tokens + S, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_loss_and_grads_match_jax(pair):
    jcfg, params, _, model, batch = pair
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: get_model(jcfg).loss(p, jb, jcfg), has_aux=True))(params)
    model.requires_grad_(True)
    try:
        total, metrics = T.loss(model, _t(batch))
        total.backward()
        assert set(metrics) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(jm[key]), rtol=1e-5, atol=1e-7)
        assert float(jm["aux"]) > 0                 # the indexer KL
        g_np = jax.tree.map(np.asarray, jg)
        for n, p in model.named_parameters():
            _close(p.grad.numpy(), _jax_leaf(g_np, model.cfg, n),
                   atol=5e-3 if ".idx." in n else 1e-5)
    finally:
        model.requires_grad_(False)
        model.zero_grad(set_to_none=True)


def test_prefill_step_and_cache_match_jax(pair):
    jcfg, params, _, model, batch = pair
    jb = {k: jnp.asarray(batch[k]) for k in ("tokens", "frontend_embeds")}
    want = np.asarray(jax_prefill_step(jcfg)(params, jb))
    got = make_prefill_step(model)(_t({k: batch[k] for k in jb}))
    assert got.shape == (B, 1, jcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # prefill into a contiguous cache, then one decode step at F + S - 1
    F = jcfg.frontend_tokens
    toks, fe = batch["tokens"], batch["frontend_embeds"]
    jm = get_model(jcfg)
    jcache, _ = jm.init_cache(jcfg, B, F + S + 8)
    jl, jcache = jm.prefill(params, jnp.asarray(toks[:, :-1]), jcfg, jcache,
                            frontend_embeds=jnp.asarray(fe))
    jl2, _ = jm.decode_step(params, jnp.asarray(toks[:, -1:]), jcfg, jcache,
                            jnp.asarray(F + S - 1, jnp.int32))
    cache = T.init_cache(model.cfg, B, F + S + 8, device="cpu")
    tl, cache = T.prefill(model, torch.from_numpy(toks[:, :-1]), cache,
                          frontend_embeds=torch.from_numpy(fe))
    tl2, _ = T.decode_step(model, torch.from_numpy(toks[:, -1:]), cache,
                           F + S - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4,
                               atol=1e-5)
    with torch.no_grad():
        full = T.logits(model, torch.from_numpy(toks),
                        frontend_embeds=torch.from_numpy(fe))
    np.testing.assert_allclose(tl.numpy()[:, 0], full[:, -2].numpy(),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tl2.numpy()[:, 0], full[:, -1].numpy(),
                               rtol=1e-4, atol=1e-5)


def _margin_ok(model, prompt, out):
    seq = torch.from_numpy(np.concatenate([prompt, out[:-1]]).astype(np.int64))
    with torch.no_grad():
        lg = T.logits(model, seq[None])[0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= MARGIN).all())


def test_engine_text_requests_match_jax_oracle(pair):
    jcfg, params, _, model, _ = pair
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (11, 70, 37, 9, 80)]
    max_new = [5, 6, 4, 7, 5]
    oracle = [JaxRequest(prompt=p, max_new=m)
              for p, m in zip(prompts, max_new)]
    JaxOracle(jcfg, params, max_batch=1, max_len=96).serve(oracle)
    eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                           num_blocks=60, max_len=96, prefill_chunk=16,
                           device="cpu")
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    eng.serve(reqs)
    assert all(r.status == "ok" for r in reqs)
    compared = 0
    for p, r, o in zip(prompts, reqs, oracle):
        if _margin_ok(model, p, o.out):
            np.testing.assert_array_equal(r.out, o.out)
            compared += 1
    assert compared >= 3
