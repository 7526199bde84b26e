"""PyTorch port, the ssm family (falcon-mamba-7b's Mamba-1 LM) against the
JAX package.

The reference's smoke config (2 layers, d_model 256, E 512, N 8), its
weights carried over with ``bridge.from_jax_params`` (which unstacks the
reference's ``layers`` axis), numpy-seeded inputs, fp32:

* ``apply_mamba1`` of a layer, with and without state (the conv and ssm
  states it returns too), and the whole model's logits: rtol 1e-4;
* prefill + decode equal to the full forward (``tests/test_models.py``'s
  ssm case), the smoke train step and decode (its :24 and :43);
* the static ``ServingEngine``'s greedy tokens against JAX's, on mixed
  prompt lengths (left-padding with token 0 runs the pad through the
  recurrence in both, so a short prompt's tokens depend on its
  batch-mates; ROADMAP queue 3), claimed where the teacher-forced top-2
  margin of the padded row is at least 1e-4;
* ``ssm_model.loss`` and every gradient against
  ``jax.value_and_grad(ssm_model.loss)`` (loss 1e-5 relative, gradients
  1e-4 relative within 1e-5 of their leaf's max); ``param_axes`` against
  the Builder specs;
* ``muon.update`` against the reference's on the per-layer tree, every
  leaf; on the reference's stacked tree, every leaf but ``conv_w``,
  ``conv_b``, ``dt_bias``, ``D`` and the norm scales, which stacking makes
  2-D with a leading ``layers`` axis, so the reference sends them to
  Newton-Schulz where the function's own comment means AdamW (ROADMAP
  queue 3); ``A_log`` keeps AdamW in both;
* ``launch.train.main --arch falcon-mamba-7b --smoke --device cpu``;
  ``ContinuousEngine`` refuses the family, as the reference's does, and
  the model constructor refuses Mamba-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config
from repro.layers.ssm import apply_mamba1 as jax_apply_mamba1
from repro.models import get_model as jax_get_model
from repro.optim import muon as jmuon
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.launch import train as ttrain
from repro_torch.layers import ssm
from repro_torch.models import get_model, ssm_model
from repro_torch.optim import muon
from repro_torch.serving import ContinuousEngine, Request, ServingEngine

MARGIN = 1e-4
QUIRK_LEAVES = ("conv_w", "conv_b", "dt_bias", "D", "norm")


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@functools.lru_cache(maxsize=None)
def _jax_init():
    jcfg = get_smoke_config("falcon_mamba_7b")
    params, specs = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, params, specs, jax.tree.map(np.asarray, params)


@pytest.fixture
def pair():
    jcfg, params, specs, params_np = _jax_init()
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    return jcfg, params, specs, params_np, model


def _tokens(vocab, B, S, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, S)).astype(np.int32)


def _close(got, want, rtol=1e-4, atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * max(np.abs(want).max(), 1e-30))


def test_registry_and_config():
    cfg = get_config("falcon-mamba-7b")
    assert get_model(cfg) is ssm_model
    model = ssm_model.SSMModel(cfg, device="meta")
    jcfg = jax_get_config("falcon_mamba_7b")
    shapes, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg,
                                         abstract=True)
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert sum(p.numel() for p in model.parameters()) == n_ref > 7.2e9
    with pytest.raises(NotImplementedError):
        ssm_model.SSMModel(cfg.replace(ssm_version=2), device="meta")


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mamba1_matches_jax(pair, with_state):
    jcfg, params, _, params_np, model = pair
    cfg = model.cfg
    B, S = 2, 19
    E, N, W = ssm.d_inner(cfg), cfg.ssm_state, cfg.ssm_conv
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lp = jax.tree.map(lambda a: a[1], params["layers"]["mamba"])
    state = None
    if with_state:
        state = {"conv": rng.standard_normal((B, W - 1, E)).astype(np.float32),
                 "ssm": rng.standard_normal((B, E, N)).astype(np.float32)}
    out_j, st_j = jax_apply_mamba1(
        lp, jnp.asarray(x), jcfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    with torch.no_grad():
        out, st = ssm.apply_mamba1(
            model.layers[1].mamba, torch.from_numpy(x), cfg,
            state=None if state is None
            else {k: torch.from_numpy(v) for k, v in state.items()})
    _close(out.numpy(), out_j)
    if with_state:
        for k in ("conv", "ssm"):
            _close(st[k].numpy(), st_j[k])
    else:
        assert st is None and st_j is None


def test_logits_match_jax(pair):
    jcfg, params, _, _, model = pair
    tok = _tokens(jcfg.vocab_size, 2, 64, seed=3)
    want = jax_get_model(jcfg).logits(params, jnp.asarray(tok), jcfg)
    with torch.no_grad():
        got = ssm_model.logits(model, torch.from_numpy(tok))
    _close(got.numpy(), want)


def test_decode_matches_forward(pair):
    """``tests/test_models.py::test_decode_matches_forward_ssm`` on the port,
    with a bf16 state too (held looser: it is rounded after every call)."""
    jcfg, _, _, _, model = pair
    cfg = model.cfg
    tok = torch.from_numpy(_tokens(cfg.vocab_size, 1, 9, seed=5))
    with torch.no_grad():
        full = ssm_model.logits(model, tok)
    for dtype, tol in ((torch.float32, 3e-4), (torch.bfloat16, 5e-2)):
        cache = ssm_model.init_cache(cfg, 1, 16, dtype=dtype, device="cpu")
        lg, cache2 = ssm_model.prefill(model, tok[:, :-1], cache)
        assert cache2 is cache and cache["ssm"].dtype == dtype
        np.testing.assert_allclose(lg[0, 0].numpy(), full[0, -2].numpy(),
                                   atol=tol, rtol=tol)
        lg2, _ = ssm_model.decode_step(model, tok[:, -1:], cache, 8)
        np.testing.assert_allclose(lg2[0, 0].numpy(), full[0, -1].numpy(),
                                   atol=tol, rtol=tol)


def test_smoke_train_step_and_decode(pair):
    """``tests/test_models.py``'s smoke train step (:24) and decode (:43)."""
    _, _, _, _, model = pair
    cfg = model.cfg
    B, S = 2, 128
    tok = torch.from_numpy(_tokens(cfg.vocab_size, B, S, seed=1))
    model.requires_grad_(True)
    total, metrics = ssm_model.loss(
        model, {"tokens": tok, "targets": torch.roll(tok, -1, 1)})
    total.backward()
    assert torch.isfinite(total) and total > 0
    assert set(metrics) == {"ce", "loss", "aux"}
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    model.requires_grad_(False)
    cache = ssm_model.init_cache(cfg, B, S + 8, device="cpu")
    logits, cache = ssm_model.prefill(model, tok, cache)
    assert logits.shape == (B, 1, cfg.vocab_size)
    t = logits.argmax(-1)
    for step in range(2):
        logits, cache = ssm_model.decode_step(model, t, cache, S + step)
        assert logits.shape == (B, 1, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        t = logits.argmax(-1)


def _padded_margin_ok(model, prompt, out, plen):
    """Teacher-forced top-2 margin of every generated token of a row the
    static engine left-padded to ``plen``."""
    seq = np.concatenate([np.zeros(plen - len(prompt), np.int64), prompt,
                          out[:-1]]).astype(np.int64)
    with torch.no_grad():
        lg = ssm_model.logits(model, torch.from_numpy(seq)[None])[0, plen - 1:]
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= MARGIN).all())


def test_static_engine_matches_jax(pair):
    jcfg, params, _, _, model = pair
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 17, 9, 12)]
    max_new = [6, 4, 7, 5]
    jreqs = [JaxRequest(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    JaxOracle(jcfg, params, max_batch=3, max_len=64).serve(jreqs)
    reqs = [Request(prompt=p, max_new=m) for p, m in zip(prompts, max_new)]
    ServingEngine(model.cfg, model, max_batch=3, max_len=64,
                  device="cpu").serve(reqs)
    compared = 0
    for i, (r, j) in enumerate(zip(reqs, jreqs)):
        assert len(r.out) == r.max_new
        batch = prompts[3 * (i // 3):3 * (i // 3) + 3]
        if not _padded_margin_ok(model, r.prompt, r.out,
                                 max(map(len, batch))):
            continue
        compared += 1
        np.testing.assert_array_equal(r.out, j.out)
    assert compared >= 3
    # left-padding matters: the pad runs through the recurrence, so prompt
    # 0's next-token logits beside the 17-token prompt are not its own
    p0 = torch.from_numpy(prompts[0].astype(np.int64))[None]
    padded = torch.cat([torch.zeros((1, 12), dtype=torch.int64), p0], 1)
    with torch.no_grad():
        moved = (ssm_model.logits(model, p0)[0, -1]
                 - ssm_model.logits(model, padded)[0, -1]).abs().max()
    assert moved > 1e-3


def test_loss_and_grads_match_jax(pair):
    jcfg, params, _, _, model = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 129)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "loss_mask": (rng.random((2, 128)) > 0.1).astype(np.float32)}
    jm = jax_get_model(jcfg)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, jcfg), has_aux=True))(params)
    model.requires_grad_(True)
    total, metrics = ssm_model.loss(model, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    total.backward()
    assert set(metrics) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmet[k]),
                                   rtol=1e-5, atol=1e-7)
    g_np = jax.tree.map(np.asarray, jg)
    for n, p in model.named_parameters():
        _close(p.grad.numpy(), _jax_leaf(g_np, model.cfg, n))


def _ref_axes(specs, name):
    node = specs
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers"] + parts[2:]
    for p in parts:
        node = node[p]
    return tuple(node[1:]) if name.startswith("layers.") else tuple(node)


def test_param_axes_match_reference_specs(pair):
    _, _, specs, _, model = pair
    axes = ssm_model.param_axes(model)
    assert set(axes) == {n for n, _ in model.named_parameters()}
    for n, ax in axes.items():
        assert ax == _ref_axes(specs, n), n


def test_muon_update_matches_reference(pair):
    jcfg, params, specs, params_np, model = pair
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    axes = ssm_model.param_axes(model)
    flat = {n: jnp.asarray(_jax_leaf(params_np, cfg, n)) for n in names}
    flat_specs = {n: _ref_axes(specs, n) for n in names}

    def ref_update(tree_specs):
        return jax.jit(lambda p, g, st: jmuon.update(
            p, g, tree_specs, st, lr=0.02, cfg=jcfg, weight_decay=0.1))

    stacked_update, flat_update = ref_update(specs), ref_update(flat_specs)
    j_state, j_flat_state = jmuon.init(params), jmuon.init(flat)
    tparams = dict(model.named_parameters())
    t_state = muon.init(tparams, axes)
    jp = params
    rng = np.random.default_rng(2)
    for _ in range(2):                      # count 1 and 2: bias correction
        g_np = jax.tree.map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32) * 0.3,
            params_np)
        jp, j_state = stacked_update(jp, jax.tree.map(jnp.asarray, g_np),
                                     j_state)
        flat, j_flat_state = flat_update(
            flat, {n: jnp.asarray(_jax_leaf(g_np, cfg, n)) for n in names},
            j_flat_state)
        t_state = muon.update(
            tparams, {n: torch.from_numpy(np.array(_jax_leaf(g_np, cfg, n)))
                      for n in names},
            axes, t_state, lr=0.02, cfg=cfg, weight_decay=0.1)
    jp_np = jax.tree.map(np.asarray, jp)
    quirk = []
    for n in names:
        got = tparams[n].detach().numpy()
        _close(got, flat[n], atol=1e-6)
        if n.split(".")[-1] in QUIRK_LEAVES and n.startswith("layers."):
            quirk.append(n)
            continue
        _close(got, _jax_leaf(jp_np, cfg, n), atol=1e-6)
    assert len(quirk) == len(QUIRK_LEAVES) * cfg.num_layers
    # per layer the conv filters, biases, D, A_log and norms take AdamW
    assert {n.split(".")[-1] for n in t_state.second} == {
        "embedding", "unembed", "final_norm", "A_log", *QUIRK_LEAVES}


def test_train_main_falcon_mamba_smoke():
    hist = ttrain.main(["--arch", "falcon-mamba-7b", "--smoke", "--steps", "3",
                        "--warmup", "0", "--batch", "2", "--seq", "32",
                        "--log-every", "1", "--device", "cpu"])
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert set(hist[0]) == {"loss", "ce", "aux", "grad_norm", "step", "lr",
                            "tok_per_s"}


def test_continuous_engine_refuses_ssm(pair):
    model = pair[-1]
    with pytest.raises(NotImplementedError, match="ssm"):
        ContinuousEngine(model.cfg, model, device="cpu")
