"""PyTorch port, the training path, against the JAX package.

The same weights (bridged with ``from_jax_params``) and numpy-seeded
batches go through both packages in fp32:

* ``transformer.loss`` and the gradient of every parameter against
  ``jax.value_and_grad(model.loss)`` for the Yi-6B smoke config (dense:
  K9's autograd Function in every layer), Yi-6B smoke + DSA (top-k 64 of
  256 positions, the indexer KL), gemma2 smoke (window 16 on the local
  layers, DSA on the global ones, attention and final softcaps, tied
  embeddings), GLM-5 smoke with ``mtp=None`` (MLA + DSA + MoE: the
  router's aux loss), GLM-5 smoke whole (its MTP head: 0.3 × the mean of
  three shared-block steps' losses, the head's block dense, so its
  indexer gets no gradient: JAX's zeros) and Yi-6B smoke with the DSA
  block selector (K8's plain version and its backward, the block-mode
  indexer loss); the loss, ce, aux (and mtp) within rtol 1e-5, every gradient
  within rtol 1e-4 and atol 1e-5 of its leaf's max |gradient|, except the
  indexer weights': their only gradient is the KL over each query's top-k
  set, and a key whose indexer dot products sit within rounding of 0 (a
  ReLU edge) or of the k-th score can be selected in one package and not
  in the other, moving that query's share, about 1/(B·S) = 2e-3, of the
  gradient; they are held within atol 5e-3 of their max |gradient| (the
  GLM-5 case's second layer needs it);
* ``param_axes`` equal to the reference's Builder specs (without the
  scanned ``layers`` axis) for those four configs;
* ``muon.update`` (Muon Split and fused, the AdamW leaves, weight decay,
  two steps so ``count`` matters) and ``global_norm_clip`` against the
  reference's, leaf by leaf, on GLM-5 smoke's parameters (MLA and indexer
  head splits, expert groups, vocab and norm leaves): against the
  reference's ``update`` run on the port's one-leaf-per-layer tree, and
  against its stacked tree for every leaf but the scanned layers' norm
  scales (2-D there, so Muon orthogonalizes them across layers: a quirk of
  the reference, ROADMAP queue 3); rtol 1e-4, atol 1e-6;
* the schedules; ``markov_stream`` equal token for token to the reference's
  numpy stream; a checkpoint round trip, and a checkpoint the reference
  writes restoring into the port through ``from_jax_params``;
* ``launch.train.main`` on the CPU for 6 steps: the loss falls by 10 %;
  with the default arch (GLM-5 smoke, MTP on) for 2 steps: it trains and
  logs the MTP loss;
  ``TrainConfig`` refuses the reference's ``optimizer`` and ``min_lr``,
  which the trainer does not read.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jckpt
from repro.configs import get_smoke_config
from repro.data import synthetic as jsyn
from repro.models import get_model
from repro.optim import muon as jmuon
from repro.optim import schedule as jschedule
from repro.sharding.rules import spec_leaf
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.checkpoint import io as ckpt
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.data import synthetic
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as T
from repro_torch.optim import muon, schedule
from _torch_threads import one_torch_thread  # noqa: F401

CONFIGS = ["yi", "yi_dsa", "gemma2", "glm5", "glm5_mtp", "yi_block"]


def _jcfg(name):
    if name == "yi":
        return get_smoke_config("yi_6b").replace(dsa=None)
    if name == "yi_dsa":
        return get_smoke_config("yi_6b")
    if name == "gemma2":
        return get_smoke_config("gemma2_2b").replace(sliding_window=16)
    if name == "glm5_mtp":
        return get_smoke_config("glm5_744b").replace(moe_impl="dense")
    if name == "yi_block":
        return get_smoke_config("yi_6b").replace(dsa=dataclasses.replace(
            get_smoke_config("yi_6b").dsa, selector="block"))
    return get_smoke_config("glm5_744b").replace(mtp=None, moe_impl="dense")


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """The reference's weights and specs of a config (made once a module:
    JAX's init of GLM-5 smoke takes seconds)."""
    jcfg = _jcfg(name)
    params, specs = get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, params, specs, jax.tree.map(np.asarray, params)


def _pair(name):
    """(jax cfg, params, specs, numpy params, a fresh port model holding
    the same weights)."""
    jcfg, params, specs, params_np = _jax_init(name)
    return jcfg, params, specs, params_np, from_jax_params(
        params_np, port_cfg(jcfg), device="cpu")


def _batch(vocab, B=2, S=256, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": mask}


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_grads_match_jax(name):
    jcfg, params, specs, params_np, model = _pair(name)
    batch = _batch(jcfg.vocab_size)
    jmodel = get_model(jcfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, batch, jcfg), has_aux=True))(params)
    model.requires_grad_(True)
    total, metrics = T.loss(model, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    total.backward()
    assert set(metrics) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(metrics[key].detach()),
                                   float(jm[key]), rtol=1e-5, atol=1e-7)
    if name != "yi":
        assert float(jm["aux"]) > 0          # MoE aux / indexer KL reach it
    g_np = jax.tree.map(np.asarray, jg)
    cfg = model.cfg
    for n, p in model.named_parameters():
        want = _jax_leaf(g_np, cfg, n)
        if p.grad is None:            # read by no loss term: JAX's zeros
            assert n.startswith("mtp.block.idx."), n
            assert not want.any(), n
            continue
        _close(p.grad.numpy(), want, atol=5e-3 if ".idx." in n else 1e-5)


def _ref_axes(specs, cfg, name):
    """The reference's spec of the port parameter ``name``, without the
    scanned ``layers`` axis."""
    parts = name.split(".")
    if parts[0] != "layers":
        node = specs
        for p in parts:
            node = node[p]
        return tuple(node)
    i = int(parts[1])
    if i < cfg.first_k_dense:
        node, scanned = specs[f"dense_{i}"], False
    else:
        j = (i - cfg.first_k_dense) % len(cfg.attention_pattern)
        node, scanned = specs[f"slot{j}"], True
    for p in parts[2:]:
        node = node[p]
    assert spec_leaf(node)
    return tuple(node[1:]) if scanned else tuple(node)


@pytest.mark.parametrize("name", CONFIGS)
def test_param_axes_match_reference_specs(name):
    jcfg = _jcfg(name)
    _, specs = get_model(jcfg).init(jax.random.key(0), jcfg, abstract=True)
    model = T.Transformer(port_cfg(jcfg), device="meta")
    axes = T.param_axes(model)
    assert set(axes) == {n for n, _ in model.named_parameters()}
    for n, ax in axes.items():
        assert ax == _ref_axes(specs, model.cfg, n), n


@pytest.mark.parametrize("split", [True, False])
def test_muon_update_matches_reference(split):
    jcfg, params, specs, params_np, model = _pair("glm5")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    axes = T.param_axes(model)
    # the reference's update on the port's layout: one leaf per layer
    # parameter, the reference's axes without the scanned 'layers' axis
    flat = {n: jnp.asarray(_jax_leaf(params_np, cfg, n)) for n in names}
    flat_specs = {n: _ref_axes(specs, cfg, n) for n in names}
    j_flat_state = jmuon.init(flat)
    j_state = jmuon.init(params)
    tparams = dict(model.named_parameters())
    t_state = muon.init(tparams, axes)
    jp = params
    rng = np.random.default_rng(2)

    def ref_update(tree_specs):
        return jax.jit(lambda p, g, st: jmuon.update(
            p, g, tree_specs, st, lr=0.02, cfg=jcfg, weight_decay=0.1,
            split=split))

    stacked_update, flat_update = ref_update(specs), ref_update(flat_specs)
    ref_clip = jax.jit(lambda g: jmuon.global_norm_clip(g, 1.0))
    for step in range(2):                   # count 1 and 2: bias correction
        g_np = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.3,
            params_np)
        jgrads, jnorm = ref_clip(jax.tree.map(jnp.asarray, g_np))
        jp, j_state = stacked_update(jp, jgrads, j_state)
        jg_np = jax.tree.map(np.asarray, jgrads)
        flat, j_flat_state = flat_update(
            flat, {n: jnp.asarray(_jax_leaf(jg_np, cfg, n)) for n in names},
            j_flat_state)
        tgrads = {n: torch.from_numpy(np.array(_jax_leaf(g_np, cfg, n)))
                  for n in names}
        tgrads, tnorm = muon.global_norm_clip(tgrads, 1.0)
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-5)
        for n in names:
            _close(tgrads[n].numpy(), _jax_leaf(jg_np, cfg, n), atol=1e-6)
        t_state = muon.update(tparams, tgrads, axes, t_state, lr=0.02,
                              cfg=cfg, weight_decay=0.1, split=split)
    assert t_state.count == int(j_state.count) == 2
    jp_np = jax.tree.map(np.asarray, jp)
    for n in names:
        got = tparams[n].detach().numpy()
        _close(got, flat[n], atol=1e-6)
        _close(t_state.momentum[n].numpy(), j_flat_state.momentum[n],
               atol=1e-6)
        # the reference's stacked tree gives the same, except for the norm
        # scales of its scanned layers: stacked (n_groups, dim) they are 2-D
        # there and take the Muon branch (ROADMAP queue 3)
        if not (got.ndim == 1 and n.startswith("layers.")
                and int(n.split(".")[1]) >= cfg.first_k_dense):
            _close(got, _jax_leaf(jp_np, cfg, n), atol=1e-6)
    # the AdamW leaves (embedding, unembedding, norms) keep second moments
    assert set(t_state.second) == {n for n in names
                                   if tparams[n].ndim == 1
                                   or n.startswith("embed.")}


def test_schedules_match_reference():
    for step in (0, 1, 5, 20, 37, 100, 150):
        for warmup in (0, 1, 20):
            np.testing.assert_allclose(
                schedule.warmup_cosine(step, peak=2e-3, floor=2e-4,
                                       warmup=warmup, total=100),
                float(jschedule.warmup_cosine(step, peak=2e-3, floor=2e-4,
                                              warmup=warmup, total=100)),
                rtol=1e-6)
        np.testing.assert_allclose(
            schedule.linear(step, start=1.0, end=0.1, total=80),
            float(jschedule.linear(step, start=1.0, end=0.1, total=80)),
            rtol=1e-6)
    assert schedule.constant(3, value=0.5) == float(
        jschedule.constant(3, value=0.5))


@pytest.mark.parametrize("vocab,branching", [(300, 8), (97, 2)])
def test_markov_stream_matches_reference(vocab, branching):
    ours = synthetic.markov_stream(vocab, 40, 3, seed=5, branching=branching)
    ref = jsyn.markov_stream(vocab, 40, 3, seed=5, branching=branching)
    for _ in range(3):
        np.testing.assert_array_equal(next(ours), next(ref))
    b = synthetic.lm_batch(ours)
    assert b["tokens"].shape == b["targets"].shape == (3, 40)


def test_checkpoints_round_trip_and_read_the_reference(tmp_path):
    jcfg, params, specs, params_np, model = _pair("yi_dsa")
    state = {"params": model.state_dict(), "step": [np.int32(3)]}
    ckpt.save_async(tmp_path / "port" / "step_3", state, step=3).join()
    ckpt.save(tmp_path / "port" / "step_10", state, step=10)
    assert ckpt.latest_step_dir(tmp_path / "port").name == "step_10"
    like = {"params": {k: torch.zeros_like(v) for k, v in
                       model.state_dict().items()}, "step": [np.int32(0)]}
    back, step = ckpt.restore(tmp_path / "port" / "step_3", like)
    assert step == 3 and int(back["step"][0]) == 3
    for k, v in model.state_dict().items():
        assert torch.equal(back["params"][k], v)
    with pytest.raises(ValueError):
        bad = dict(like, params=dict(like["params"]))
        bad["params"]["embed.embedding"] = torch.zeros(3, 3)
        ckpt.restore(tmp_path / "port" / "step_3", bad)
    # a checkpoint the reference writes, restored into the reference's
    # layout and carried into the port by the weight bridge
    jckpt.save(tmp_path / "ref", {"params": params}, step=7)
    tree, step = ckpt.restore(tmp_path / "ref", {"params": params_np})
    assert step == 7
    restored = from_jax_params(tree["params"], model.cfg, device="cpu")
    for (n, a), (_, b) in zip(restored.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n


def test_train_main_loss_falls():
    hist = ttrain.main(["--arch", "yi-6b", "--smoke", "--dense-attn",
                        "--steps", "6", "--warmup", "0", "--lr", "3e-3",
                        "--batch", "4", "--seq", "128", "--log-every", "1",
                        "--device", "cpu"])
    losses = [h["loss"] for h in hist]
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9
    assert set(hist[0]) == {"loss", "ce", "aux", "grad_norm", "step", "lr",
                            "tok_per_s"}


def test_train_main_default_arch_trains_glm5_with_mtp():
    """The reference's default ``--arch glm-5`` on its smoke config: MLA +
    DSA + MoE + the MTP head trains, its loss logged every step (that
    losses fall is ``test_train_main_loss_falls``'s and the chip's)."""
    hist = ttrain.main(["--smoke", "--steps", "2", "--warmup", "0",
                        "--batch", "2", "--seq", "32", "--log-every", "1",
                        "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and h["mtp"] > 0 for h in hist)
    assert set(hist[0]) == {"loss", "ce", "aux", "mtp", "grad_norm", "step",
                            "lr", "tok_per_s"}


@pytest.mark.parametrize("knob", [{"optimizer": "adamw"}, {"min_lr": 1e-5}])
def test_train_config_refuses_unread_knobs(knob):
    with pytest.raises(TypeError):
        TrainConfig(**knob)
