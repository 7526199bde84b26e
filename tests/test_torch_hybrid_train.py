"""PyTorch port, training the hybrid family (zamba2-2.7b: Mamba-2 layers
and one shared attention block), against the JAX package.

* ``ref.scan_heads_grads`` (the head-shared scan's gradient by the chunked
  form, no loop over time) against ``jax.vjp`` of the reference's
  ``layers/ssm._mamba2_scan`` fed dA = exp(dt·A) and x·dt, every input (h0
  included), with and without a cotangent on hT, S 1 / 63 / 64 / 130
  (chunks of 64: one short chunk, one whole, a ragged third) and A down to
  -80 (``A_log = log(1..80)``): 1e-5 of each leaf's max; and against torch
  autograd through the stepped ``ref.scan_heads``;
* ``apply_mamba2``'s output and every gradient against ``jax.vjp`` of the
  reference's ``apply_mamba2``, 1e-5 of each leaf's max, and its scan
  taking K11's autograd Function (``_MambaScanHeads``) only where a
  gradient is wanted;
* ``hybrid.loss`` and the gradient of every parameter against
  ``jax.value_and_grad(repro.models.hybrid.loss)`` on the zamba2 smoke
  config through ``from_jax_params``, dense and + DSA (S 128 past its
  top-k 64), fp32: the loss within rtol 1e-4, every gradient within 1e-4
  of its leaf's max; the DSA indexer's leaves get no gradient in the port
  (the reference drops the indexer loss) and zeros in JAX;
* ``muon.update`` against the reference's on the per-layer tree (in_proj
  and out_proj by Newton-Schulz; conv_w, the 1-D Mamba-2 leaves and the
  norms by AdamW), two steps;
* ``launch.train.main --arch zamba2-2.7b --smoke --device cpu``, dense and
  + DSA: the loss falls; the port's mirror of
  ``tests/test_models.py::test_smoke_train_step[zamba2_2p7b]``.

One JAX oracle a module: the reference's weights, losses and gradients
are made once (module-scoped fixtures).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.layers.ssm import _mamba2_scan
from repro.layers.ssm import apply_mamba2 as jax_apply_mamba2
from repro.models import get_model as jax_get_model
from repro.optim import muon as jmuon
from repro_torch.bridge import _jax_leaf, from_jax_params
from repro_torch.configs import get_smoke_config as port_smoke_config
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.kernels.mamba_scan import kernel as K11
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.launch import train as ttrain
from repro_torch.layers import ssm
from repro_torch.models import get_model, hybrid
from repro_torch.optim import muon
from _torch_threads import one_torch_thread  # noqa: F401


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _close(got, want, tol):
    """|got - want| <= tol x max |want| elementwise."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _scan_inputs(rng, B, S, H, P, N):
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0))
    A = -np.arange(1, H + 1, dtype=np.float64)           # down to -H
    x = rng.standard_normal((B, S, H * P))
    Bc, Cc = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    h0 = 0.5 * rng.standard_normal((B, H, P, N))
    return [a.astype(np.float32) for a in (dt, A, x, Bc, Cc, h0)]


def _jax_scan(dt, A, x, Bc, Cc, h0):
    B, S, H = dt.shape
    x_dt = x.reshape(B, S, H, -1) * dt[..., None]
    return _mamba2_scan(jnp.exp(dt * A), x_dt, Bc, Cc, h0)


@pytest.mark.parametrize("with_g_hT", [True, False], ids=["g_hT", "no_g_hT"])
@pytest.mark.parametrize("S", [1, 63, 64, 130])
def test_scan_heads_grads_match_jax(S, with_g_hT):
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 80, 4, 8
    ins = _scan_inputs(rng, B, S, H, P, N)
    g_y = rng.standard_normal((B, S, H, P)).astype(np.float32)
    g_hT = rng.standard_normal((B, H, P, N)).astype(np.float32) \
        if with_g_hT else np.zeros((B, H, P, N), np.float32)
    _, vjp = jax.vjp(_jax_scan, *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(g_y), jnp.asarray(g_hT)))
    t_ins = [torch.from_numpy(a) for a in ins]
    got = scan_ref.scan_heads_grads(
        *t_ins, torch.from_numpy(g_y),
        torch.from_numpy(g_hT) if with_g_hT else None)
    # torch autograd through the stepped plain scan
    leaves = [t.clone().requires_grad_() for t in t_ins]
    y, hT = scan_ref.scan_heads(*leaves)
    outs = [y, hT] if with_g_hT else [y]
    cots = [torch.from_numpy(g_y), torch.from_numpy(g_hT)][:len(outs)]
    stepped = torch.autograd.grad(outs, leaves, cots)
    names = ("dt", "A", "x", "Bc", "Cc", "h0")
    for name, g, w, s in zip(names, got, want, stepped):
        assert g.dtype == torch.float32, name
        _close(g.numpy(), w, 1e-5)
        _close(g.numpy(), s.numpy(), 1e-5)


def test_scan_heads_chunked_forward_matches_stepped():
    """The chunked form the gradient differentiates is the stepped scan's
    function (S 200: a ragged last chunk), dtypes cast as the wrapper's."""
    ins = [torch.from_numpy(a) for a in
           _scan_inputs(np.random.default_rng(5), 2, 200, 80, 4, 8)]
    want = scan_ref.scan_heads(*ins)
    got = scan_ref.scan_heads_chunked(*ins)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy(), 1e-5)


@pytest.fixture(scope="module")
def dense_oracle():
    jcfg = get_smoke_config("zamba2_2p7b").replace(dsa=None)
    params, specs = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, params, specs, jax.tree.map(np.asarray, params)


def _layer_tree(params_np, i):
    return jax.tree.map(lambda x: jnp.asarray(x[i]),
                        params_np["layers"]["mamba"])


def test_apply_mamba2_grads_match_jax(dense_oracle):
    jcfg, _, _, params_np = dense_oracle
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg, m = model.cfg, model.layers[1].mamba
    rng = np.random.default_rng(3)
    B, S = 2, 70
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    g = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    lp = _layer_tree(params_np, 1)
    want, vjp = jax.vjp(
        lambda p, xx: jax_apply_mamba2(p, xx, jcfg)[0], lp, jnp.asarray(x))
    g_p, g_x = vjp(jnp.asarray(g))
    m.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.apply_mamba2(m, xt, cfg)
    _close(out.detach().numpy(), want, 1e-5)
    out.backward(torch.from_numpy(g))
    _close(xt.grad.numpy(), g_x, 1e-5)
    for name, p in m.named_parameters():
        _close(p.grad.numpy(), g_p[name], 1e-5)


def test_apply_mamba2_scan_function_only_for_gradients(dense_oracle):
    jcfg, _, _, params_np = dense_oracle
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg, m = model.cfg, model.layers[0].mamba
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 9, cfg.d_model)).astype(np.float32))

    def scan_nodes(out):
        seen, todo, found = set(), [out.grad_fn], 0
        while todo:
            fn = todo.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            found += type(fn).__name__ == "_MambaScanHeadsBackward"
            todo.extend(f for f, _ in fn.next_functions)
        return found

    m.requires_grad_(True)
    out, _ = ssm.apply_mamba2(m, x, cfg)
    assert scan_nodes(out) == 1
    with torch.no_grad():
        served, _ = ssm.apply_mamba2(m, x, cfg)
    assert served.grad_fn is None
    torch.testing.assert_close(served, out.detach(), rtol=0, atol=0)
    # serving (no grad) calls the wrapper alone, as before
    calls = []
    real = K11._MambaScanHeads.apply
    K11._MambaScanHeads.apply = lambda *a: calls.append(1) or real(*a)
    try:
        with torch.no_grad():
            ssm.apply_mamba2(m, x, cfg, state=ssm.mamba2_state(cfg, 1))
    finally:
        K11._MambaScanHeads.apply = real
    assert not calls


def _batch(vocab, seed, B=2, S=128):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:],
            "loss_mask": (rng.random((B, S)) > 0.1).astype(np.float32)}


@pytest.fixture(scope="module", params=["dense", "dsa"])
def loss_oracle(request):
    jcfg = get_smoke_config("zamba2_2p7b")
    if request.param == "dense":
        jcfg = jcfg.replace(dsa=None)
    params, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    batch = _batch(jcfg.vocab_size, 1)
    jm = jax_get_model(jcfg)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, batch, jcfg), has_aux=True))(params)
    return (jcfg, jax.tree.map(np.asarray, params), batch, float(loss),
            {k: float(v) for k, v in metrics.items()},
            jax.tree.map(np.asarray, grads))


def test_loss_and_grads_match_jax(loss_oracle):
    jcfg, params_np, batch, j_loss, j_metrics, j_grads = loss_oracle
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    model.requires_grad_(True)
    total, metrics = hybrid.loss(model, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    total.backward()
    assert set(metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k].detach()), v, rtol=1e-4,
                                   atol=1e-7)
    assert float(metrics["aux"]) == 0.0
    idx = 0
    for n, p in model.named_parameters():
        want = _jax_leaf(j_grads, model.cfg, n)
        if ".idx." in n:            # the indexer loss is dropped in both
            idx += 1
            assert p.grad is None, n
            assert not np.any(want), n
            continue
        _close(p.grad.numpy(), want, 1e-4)
    assert (idx > 0) == (jcfg.dsa is not None)


def _ref_axes(specs, name):
    node = specs
    parts = name.split(".")
    if parts[0] == "layers":
        parts = ["layers"] + parts[2:]
    for p in parts:
        node = node[p]
    return tuple(node[1:]) if name.startswith("layers.") else tuple(node)


def test_muon_update_matches_reference(dense_oracle):
    jcfg, _, specs, params_np = dense_oracle
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    names = [n for n, _ in model.named_parameters()]
    axes = hybrid.param_axes(model)
    assert all(axes[n] == _ref_axes(specs, n) for n in names)
    flat = {n: jnp.asarray(_jax_leaf(params_np, cfg, n)) for n in names}
    flat_specs = {n: _ref_axes(specs, n) for n in names}
    update = jax.jit(lambda p, g, st: jmuon.update(
        p, g, flat_specs, st, lr=0.02, cfg=jcfg, weight_decay=0.1))
    j_state = jmuon.init(flat)
    tparams = dict(model.named_parameters())
    t_state = muon.init(tparams, axes)
    rng = np.random.default_rng(2)
    for _ in range(2):                      # count 1 and 2: bias correction
        g_np = {n: rng.standard_normal(tuple(p.shape)).astype(np.float32)
                * 0.3 for n, p in tparams.items()}
        flat, j_state = update(flat, {n: jnp.asarray(g)
                                      for n, g in g_np.items()}, j_state)
        t_state = muon.update(tparams, {n: torch.from_numpy(g)
                                        for n, g in g_np.items()},
                              axes, t_state, lr=0.02, cfg=cfg,
                              weight_decay=0.1)
    for n in names:
        np.testing.assert_allclose(tparams[n].detach().numpy(),
                                   np.asarray(flat[n]), rtol=1e-4,
                                   atol=1e-6 * max(
                                       np.abs(np.asarray(flat[n])).max(),
                                       1e-30))
    # per layer: in_proj / out_proj by Newton-Schulz, the rest by AdamW
    adamw = {n.split(".")[-1] for n in t_state.second
             if n.startswith("layers.")}
    assert adamw == {"norm", "conv_w", "conv_b", "A_log", "dt_bias", "D",
                     "gate_norm"}


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "dsa"])
def test_train_main_zamba2_smoke_loss_falls(dense):
    argv = ["--arch", "zamba2-2.7b", "--smoke", "--steps", "6", "--warmup",
            "0", "--batch", "2", "--seq", "64", "--log-every", "1",
            "--device", "cpu"]
    hist = ttrain.main(argv + (["--dense-attn"] if dense else []))
    assert [h["step"] for h in hist] == list(range(6))
    losses = [h["loss"] for h in hist]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(h["aux"] == 0.0 for h in hist)


def test_smoke_train_step_zamba2():
    """The port's mirror of ``tests/test_models.py::test_smoke_train_step``
    for zamba2_2p7b: the smoke config, B 2, S 128, one loss and its
    gradients, finite."""
    cfg = port_smoke_config("zamba2_2p7b")
    assert cfg.num_layers <= 4 and cfg.d_model <= 512
    M = get_model(cfg)
    model = M.init(cfg, device="cpu")
    model.requires_grad_(True)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen)
    total, _ = M.loss(model, {"tokens": tok,
                              "targets": torch.roll(tok, -1, 1)})
    assert torch.isfinite(total) and total > 0
    total.backward()
    for n, p in model.named_parameters():
        assert p.grad is None or torch.isfinite(p.grad).all(), n
