"""PyTorch port: the four transformer configs of the registry that no
earlier file exercises, their smoke configs (each with its DSA retrofit)
against the JAX package through ``from_jax_params``:

* qwen3-moe (``qk_norm`` on q and k, 4 routed experts top-2, no shared
  expert), kimi-k2 (a dense first layer, ``first_k_dense=1``, then MoE
  with one shared expert), nemotron-4 and minitron (squared-ReLU MLPs);
* logits without a cache over 128 tokens (past the indexer's top-k of
  64) against the reference's, fp32 rtol 1e-4;
* the loss (cross-entropy, the MoE router's aux loss, 0.01 × the indexer
  KL) and every gradient against ``jax.value_and_grad`` of the reference's
  ``loss``: the loss within rtol 1e-5, every gradient within rtol 1e-4 and
  1e-5 of its leaf's max, the indexer weights' within 5e-3
  (``test_torch_train``'s rule for a near-tie in a top-k set).

One JAX oracle a config, made once a module.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models import get_model
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.models import transformer as T
from test_torch_dsa import port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["qwen3_moe_235b", "kimi_k2_1t", "nemotron4_15b", "minitron_4b"]
B, S = 2, 128


@functools.lru_cache(maxsize=None)
def _pair(arch):
    jcfg = get_smoke_config(arch)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    return jcfg, params, model, batch


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def test_configs_carry_their_layers():
    qwen, kimi, nemo, mini = (_pair(a)[2] for a in ARCHS)
    assert hasattr(qwen.layers[0].attn, "q_norm")
    assert hasattr(qwen.layers[0], "moe")
    assert not hasattr(qwen.layers[0].moe, "ws_gate")
    assert hasattr(kimi.layers[0], "mlp") and hasattr(kimi.layers[1], "moe")
    assert hasattr(kimi.layers[1].moe, "ws_gate")
    for m in (nemo, mini):
        assert m.cfg.mlp_activation == "relu2"
        assert not hasattr(m.layers[0].mlp, "w_gate")


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax(arch):
    jcfg, params, model, batch = _pair(arch)
    want = get_model(jcfg).logits(params, jnp.asarray(batch["tokens"]), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(batch["tokens"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, params, model, batch = _pair(arch)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: get_model(jcfg).loss(p, jb, jcfg), has_aux=True))(params)
    model.requires_grad_(True)
    try:
        total, metrics = T.loss(model, {k: torch.from_numpy(v)
                                        for k, v in batch.items()})
        total.backward()
        assert set(metrics) == set(jm)
        for key in jm:
            np.testing.assert_allclose(float(metrics[key].detach()),
                                       float(jm[key]), rtol=1e-5, atol=1e-7)
        assert float(jm["aux"]) > 0
        g_np = jax.tree.map(np.asarray, jg)
        for n, p in model.named_parameters():
            _close(p.grad.numpy(), _jax_leaf(g_np, model.cfg, n),
                   atol=5e-3 if ".idx." in n else 1e-5)
    finally:
        model.requires_grad_(False)
        model.zero_grad(set_to_none=True)
