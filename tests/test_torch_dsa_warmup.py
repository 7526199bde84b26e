"""PyTorch port, the DSA indexer's warm-up (GLM-5 §2.1.1: the indexer
trains, the base is frozen).

* The mirror of ``tests/test_dsa.py``'s
  ``test_indexer_warmup_distillation_improves``: 25 plain gradient steps
  (lr 0.5) on the indexer of the Yi-6B smoke config's first layer against
  the head-mean dense attention (``indexer_distill_loss``) lower the KL
  below 0.9 x its start; the port's KL before and after equal the
  reference's (rtol 1e-5 and 1e-3: 25 steps of rounding).
* ``make_train_step(freeze="all_but_indexer")`` for 3 steps on the Yi-6B
  smoke config (DSA, top-k 64, seq 128) against ``benchmarks.common.
  train_lm(freeze="all_but_indexer")`` (the reference's warm-up loop: the
  gradients outside ``idx`` zeroed, clipped, Muon without weight decay at
  a constant lr 2e-3) under the same seed and batches: every frozen leaf
  bitwise unchanged on both sides; the indexer leaves within
  ``chip_smoke.py``'s ``train_parity`` bound of the reference's (all
  Muon leaves: 1e-3 x lr); the losses within 1e-5 relative.
* ``launch.train.train(freeze=...)``: the base bitwise unchanged under the
  trainer's weight decay, and the refusals (an unknown ``freeze``, a
  config without an indexer).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import dsa as jdsa
from repro.layers.attention import attention_mask as jax_mask
from repro.layers.attention import gqa_qkv as jax_gqa_qkv
from repro.models import get_model
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.configs.base import TrainConfig
from repro_torch.core import dsa as tdsa
from repro_torch.data.synthetic import markov_stream
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step, trained_names
from repro_torch.layers.attention import attention_mask, gqa_qkv
from repro_torch.models import transformer as T
from repro_torch.optim import muon
from test_torch_train import port_cfg
from _torch_threads import one_torch_thread  # noqa: F401

LR = 2e-3


@pytest.fixture(scope="module")
def yi_dsa():
    jcfg = get_smoke_config("yi_6b")
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, params, jax.tree.map(np.asarray, params)


def test_indexer_warmup_distillation_improves(yi_dsa):
    jcfg, params, params_np = yi_dsa
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    lp = jax.tree.map(lambda x: x[0], params["slot0"])
    B, S = 2, 64
    x = jax.random.normal(jax.random.key(1), (B, S, jcfg.d_model))
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    mask = jax_mask(pos, pos, causal=True)
    q, k, _ = jax_gqa_qkv(lp["attn"], x, jcfg, pos)
    kr = jnp.repeat(k, jcfg.num_heads // jcfg.num_kv_heads, 2)
    s = jnp.einsum("bshd,bthd->bhst", q, kr) * (jcfg.head_dim ** -0.5)
    attn = jax.nn.softmax(jnp.where(mask[:, None], s, -1e30), -1).mean(1)

    def jax_loss(ip):
        ki = jdsa.indexer_keys(ip, x, jcfg.dsa)
        return jdsa.indexer_distill_loss(
            jdsa.indexer_scores(ip, x, ki, jcfg.dsa), attn, mask)

    want = [float(jax_loss(lp["idx"]))]
    p = lp["idx"]
    for _ in range(25):
        p = jax.tree.map(lambda a, b: a - 0.5 * b, p, jax.grad(jax_loss)(p))
    want.append(float(jax_loss(p)))

    # the port: its own attention probabilities from the bridged layer
    layer = model.layers[0]
    tx = torch.from_numpy(np.array(x))
    tpos = torch.from_numpy(np.array(pos))
    tmask = attention_mask(tpos, tpos, causal=True)
    with torch.no_grad():
        tq, tk, _ = gqa_qkv(layer.attn, tx, cfg, tpos)
        tkr = tk.repeat_interleave(cfg.num_heads // cfg.num_kv_heads, 2)
        ts = torch.einsum("bshd,bthd->bhst", tq, tkr) * cfg.head_dim ** -0.5
        tattn = torch.softmax(torch.where(tmask[:, None], ts, -1e30),
                              -1).mean(1)
    idx = layer.idx
    idx.requires_grad_(True)

    def port_loss():
        ki = tdsa.indexer_keys(idx, tx)
        return tdsa.indexer_distill_loss(
            tdsa.indexer_scores(idx, tx, ki, cfg.dsa), tattn, tmask)

    got = [float(port_loss().detach())]
    for _ in range(25):
        grads = torch.autograd.grad(port_loss(), list(idx.parameters()))
        with torch.no_grad():
            for w, g in zip(idx.parameters(), grads):
                w -= 0.5 * g
    got.append(float(port_loss().detach()))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    assert got[1] < got[0] * 0.9, got


def test_freeze_steps_match_reference_warmup(yi_dsa):
    from benchmarks.common import train_lm
    jcfg, params, params_np = yi_dsa
    steps, batch, seq = 3, 4, 128
    ref = train_lm(jcfg, steps=steps, batch=batch, seq=seq, lr=LR, seed=0,
                   freeze="all_but_indexer")
    ref_np = jax.tree.map(np.asarray, ref["params"])

    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    tc = TrainConfig(batch_size=batch, seq_len=seq, weight_decay=0.0)
    step = make_train_step(model, train_cfg=tc, lr=LR,
                           freeze="all_but_indexer")
    axes = T.param_axes(model)
    opt = muon.init(dict(model.named_parameters()), axes)
    stream = markov_stream(cfg.vocab_size, seq, batch, seed=0)
    losses = []
    for _ in range(steps):
        arr = torch.from_numpy(next(stream))
        opt, metrics = step(opt, {"tokens": arr[:, :-1],
                                  "targets": arr[:, 1:]})
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    trained = 0
    for n, p in model.named_parameters():
        want = _jax_leaf(ref_np, cfg, n)
        before = _jax_leaf(params_np, cfg, n)
        got = p.detach().numpy()
        if "idx" not in n.split("."):
            assert torch.equal(p.detach(), start[n]), n      # port: frozen
            np.testing.assert_array_equal(want, before, err_msg=n)  # ref
            continue
        trained += 1
        assert muon._is_muon_param(axes[n], tuple(p.shape)), n
        assert not np.array_equal(got, before), n
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * LR,
                                   err_msg=n)
    assert trained == 3 * cfg.num_layers


def test_trainer_freeze_keeps_the_base_and_refuses(yi_dsa):
    jcfg, _, params_np = yi_dsa
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    tc = TrainConfig(batch_size=2, seq_len=64, total_steps=2,
                     warmup_steps=0, weight_decay=0.1)
    hist = ttrain.train(cfg, tc, device="cpu", model=model, log_every=1,
                        freeze="all_but_indexer")
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), start[n])]
    assert moved and all("idx" in n.split(".") for n in moved)
    assert len(moved) == 3 * cfg.num_layers
    with pytest.raises(ValueError, match="freeze"):
        make_train_step(model, freeze="all_but_attention")
    dense = T.init(cfg.replace(dsa=None), device="cpu")
    with pytest.raises(ValueError, match="indexer"):
        make_train_step(dense, freeze="all_but_indexer")
    # without freeze every parameter trains again
    make_train_step(model)
    assert all(p.requires_grad for p in model.parameters())


def test_trained_names_follow_the_reference_idx_paths(yi_dsa):
    """Every port parameter under an ``idx`` module is one of the
    reference's ``idx`` leaves (``is_idx_path``), and no other is."""
    jcfg, params, params_np = yi_dsa
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    ref_idx = set()

    def visit(path, _):
        if any(getattr(p, "key", None) == "idx" for p in path):
            ref_idx.add(path[-1].key)
    jax.tree_util.tree_map_with_path(visit, params)
    names = trained_names(model, "all_but_indexer")
    assert {n.split(".")[-1] for n in names} == ref_idx
    assert trained_names(model, None) == [n for n, _ in
                                          model.named_parameters()]
