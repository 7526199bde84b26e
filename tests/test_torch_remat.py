"""PyTorch port: ``cfg.remat`` / ``remat_group`` in the transformer's
training forward, against the JAX package.

The same weights (bridged with ``from_jax_params``) and a numpy-seeded
batch.  For Yi-6B's smoke config at 3 layers (3 pattern groups) and
kimi-k2's at 3 (a dense first layer outside the checkpoints, then 2 MoE
groups; DSA on, whose chunks keep their own checkpoints inside):

* the loss with ``remat="full"`` at every ``remat_group`` (1, a group
  count that divides the groups, and 2 on Yi-6B / 3 on kimi-k2, which do
  not and fall back to one group a checkpoint, as the reference) equals
  the port's without remat and the reference's ``remat="full"`` loss at
  rtol 1e-5;
* every gradient equals the port's without remat at rtol 1e-5 (of its
  leaf's max);
* the layers really are recomputed: the groups under a checkpoint run
  twice a step, the ``first_k_dense`` layers once, and a checkpoint
  covers ``remat_group`` groups (one where that does not divide them).

One JAX oracle for the file.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import get_model as jax_get_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.models import transformer
from _torch_threads import one_torch_thread  # noqa: F401

CASES = {"yi_6b": (1, 3, 2), "kimi_k2_1t": (1, 2, 3)}


def _jcfg(arch):
    return jax_smoke(arch).replace(num_layers=3)


def _port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _batch(vocab, B=2, S=48, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": mask}


@pytest.fixture(scope="module")
def oracle():
    """Per arch: the numpy weights, the batch and the reference's
    remat='full' loss."""
    out = {}
    for arch, groups in CASES.items():
        jcfg = _jcfg(arch)
        model = jax_get_model(jcfg)
        params, _ = model.init(jax.random.key(0), jcfg)
        batch = _batch(jcfg.vocab_size)
        # at the group count that does not divide: the reference's
        # fallback (its value is the same at every group count)
        c = jcfg.replace(remat="full", remat_group=groups[-1])
        loss = float(jax.jit(lambda p: model.loss(p, batch, c)[0])(params))
        out[arch] = (jcfg, jax.tree.map(np.asarray, params), batch, loss)
    return out


def _loss_and_grads(model, batch, cfg):
    model.cfg = cfg
    model.requires_grad_(True)
    for p in model.parameters():
        p.grad = None
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    total, _ = transformer.loss(model, t)
    total.backward()
    return float(total.detach()), {k: p.grad.clone() for k, p in
                          model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("arch", list(CASES))
def test_remat_equals_no_remat_and_reference(oracle, arch, monkeypatch):
    jcfg, params_np, batch, want = oracle[arch]
    cfg = _port_cfg(jcfg)
    model = from_jax_params(params_np, cfg, device="cpu")
    loss0, grads0 = _loss_and_grads(model, batch, cfg)
    calls, ckpts = [], []
    block, ckpt = transformer.apply_block, transformer.checkpoint
    monkeypatch.setattr(transformer, "apply_block",
                        lambda *a, **k: calls.append(1) or block(*a, **k))
    monkeypatch.setattr(transformer, "checkpoint",
                        lambda *a, **k: ckpts.append(1) or ckpt(*a, **k))
    ng = transformer.n_groups(cfg)
    for g in CASES[arch]:
        calls.clear()
        ckpts.clear()
        loss, grads = _loss_and_grads(
            model, batch, cfg.replace(remat="full", remat_group=g))
        L, k = cfg.num_layers, cfg.first_k_dense
        assert len(calls) == L + (L - k), (arch, g)   # checkpointed twice
        assert len(ckpts) == (ng // g if ng % g == 0 else ng), (arch, g)
        np.testing.assert_allclose(loss, loss0, rtol=1e-5)
        np.testing.assert_allclose(loss, want, rtol=1e-5)
        assert set(grads) == set(grads0)
        for name, g0 in grads0.items():
            np.testing.assert_allclose(
                grads[name].numpy(), g0.numpy(), rtol=1e-5,
                atol=1e-5 * float(g0.abs().max()) + 1e-30, err_msg=name)


def test_remat_and_moe_impl_settings():
    """A setting the port cannot honour fails when the config is built."""
    cfg = _port_cfg(_jcfg("yi_6b"))
    with pytest.raises(ValueError):
        cfg.replace(remat="offload")
    with pytest.raises(ValueError):
        cfg.replace(moe_impl="ragged")
