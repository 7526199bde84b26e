"""PyTorch port, the hybrid family (zamba2-2.7b: Mamba-2 layers and one
shared attention block) against the JAX package.

The reference's zamba2 smoke config (4 layers, 2 groups, d_model 256, E
512 in 8 heads of 64, N 16; DSA on its shared block unless switched off),
its weights carried over with ``bridge.from_jax_params`` (which unstacks
the reference's ``layers`` axis and reads ``shared_attn`` as it is),
numpy-seeded inputs, fp32:

* ``apply_mamba2`` of a layer with and without state (the conv and ssm
  states it returns too), rtol 1e-5; an S-step decode chained a token at
  a time equal to one full pass, rtol 1e-5;
* K11's plain head-shared scan (``ref.scan_heads``) against the
  reference's ``_mamba2_scan`` and against K11's plain Mamba-1 form fed
  the head's dt and A broadcast to its channels, rtol 1e-5;
* the whole model's logits against ``repro.models.hybrid.logits``, with
  ``dsa=None`` and with DSA, rtol 1e-4;
* paged prefill and decode (the shared block's KV in a shuffled block
  pool, the states per slot) equal to the contiguous cache's
  (``tests/test_paged_serving.py``'s hybrid case);
* ``from_jax_params``' weight count on the hybrid tree, the registry, the
  port's own init, and the transformer still refusing the family.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.layers.ssm import _mamba2_scan
from repro.layers.ssm import apply_mamba2 as jax_apply_mamba2
from repro.models import get_model as jax_get_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.layers import ssm
from repro_torch.models import get_model, hybrid
from repro_torch.models import transformer as T


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@functools.lru_cache(maxsize=None)
def _jax_init(dsa: bool):
    jcfg = get_smoke_config("zamba2_2p7b")
    if not dsa:
        jcfg = jcfg.replace(dsa=None)
    params, _ = jax_get_model(jcfg).init(jax.random.key(0), jcfg)
    return jcfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(params=[False, True], ids=["dense", "dsa"])
def pair(request):
    jcfg, params, params_np = _jax_init(request.param)
    return jcfg, params, from_jax_params(params_np, port_cfg(jcfg),
                                         device="cpu")


def _close(got, want, rtol):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def _layer0(params):
    return jax.tree.map(lambda x: x[0], params["layers"]["mamba"])


@pytest.mark.parametrize("with_state", [False, True])
def test_apply_mamba2_matches_jax(with_state):
    jcfg, params, _ = _jax_init(False)
    model = from_jax_params(jax.tree.map(np.asarray, params),
                            port_cfg(jcfg), device="cpu")
    cfg = model.cfg
    B, S = 2, 13
    E, N, P = ssm.d_inner(cfg), cfg.ssm_state, cfg.ssm_head_dim
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    state = None
    if with_state:
        state = {"conv": rng.standard_normal(
            (B, cfg.ssm_conv - 1, E + 2 * N)).astype(np.float32),
            "ssm": rng.standard_normal((B, E // P, P, N)).astype(np.float32)}
    want, want_st = jax_apply_mamba2(
        _layer0(params), jnp.asarray(x), jcfg,
        state=None if state is None else jax.tree.map(jnp.asarray, state))
    got, got_st = ssm.apply_mamba2(
        model.layers[0].mamba, torch.from_numpy(x), cfg,
        state=None if state is None else
        {k: torch.from_numpy(v) for k, v in state.items()})
    _close(got, want, 1e-5)
    if with_state:
        for k in ("conv", "ssm"):
            _close(got_st[k], want_st[k], 1e-5)
    else:
        assert got_st is None and want_st is None


def test_mamba2_decode_chain_equals_full_pass():
    jcfg, _, params_np = _jax_init(False)
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    cfg, m = model.cfg, model.layers[1].mamba
    B, S = 2, 9
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal(
        (B, S, cfg.d_model)).astype(np.float32))
    full, full_st = ssm.apply_mamba2(m, x, cfg,
                                     state=ssm.mamba2_state(cfg, B))
    st = ssm.mamba2_state(cfg, B)
    steps = []
    for t in range(S):
        y, st = ssm.apply_mamba2(m, x[:, t:t + 1], cfg, state=st)
        steps.append(y)
    _close(torch.cat(steps, 1), full, 1e-5)
    for k in ("conv", "ssm"):
        _close(st[k], full_st[k], 1e-5)


def _scan_inputs(seed, B=2, S=11, H=3, P=4, N=16):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.log(np.arange(1, H + 1))).astype(np.float32) * 0.3
    x = rng.standard_normal((B, S, H * P)).astype(np.float32)
    Bc = rng.standard_normal((B, S, N)).astype(np.float32)
    Cc = rng.standard_normal((B, S, N)).astype(np.float32)
    h0 = rng.standard_normal((B, H, P, N)).astype(np.float32)
    return dt, A, x, Bc, Cc, h0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_head_scan_matches_mamba2_scan(seed):
    dt, A, x, Bc, Cc, h0 = _scan_inputs(seed)
    B, S, H = dt.shape
    P = x.shape[-1] // H
    dA = jnp.exp(jnp.asarray(dt) * jnp.asarray(A)[None, None])
    x_dt = jnp.asarray(x).reshape(B, S, H, P) * jnp.asarray(dt)[..., None]
    want_y, want_h = _mamba2_scan(dA, x_dt, jnp.asarray(Bc), jnp.asarray(Cc),
                                  jnp.asarray(h0))
    y, hT = scan_ref.scan_heads(*map(torch.from_numpy,
                                     (dt, A, x, Bc, Cc, h0)))
    _close(y, want_y, 1e-5)
    _close(hT, want_h, 1e-5)
    # K11's Mamba-1 form, the head's dt and A broadcast to its channels
    N = Bc.shape[-1]
    dt_e = np.repeat(dt, P, axis=-1)
    A_e = np.repeat(A, P)[:, None] * np.ones((1, N), np.float32)
    y1, h1 = scan_ref.scan_model(*map(torch.from_numpy, (
        dt_e, A_e, x, Bc, Cc, h0.reshape(B, H * P, N))))
    _close(y, y1.reshape(B, S, H, P), 1e-5)
    _close(hT, h1.reshape(B, H, P, N), 1e-5)


def test_plain_head_scan_keeps_a_bf16_state():
    dt, A, x, Bc, Cc, h0 = _scan_inputs(3)
    ins = list(map(torch.from_numpy, (dt, A, x, Bc, Cc, h0)))
    ins[-1] = ins[-1].bfloat16()
    y, hT = scan_ref.scan_heads(*ins)
    assert y.dtype == torch.float32 and hT.dtype == torch.bfloat16
    want_y, want_h = scan_ref.scan_heads(*ins[:-1], ins[-1].float())
    _close(y, want_y, 1e-6)
    assert torch.equal(hT, want_h.bfloat16())


def test_hybrid_logits_match_jax(pair):
    jcfg, params, model = pair
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    want = jax_get_model(jcfg).logits(params, jnp.asarray(toks), jcfg)
    got = hybrid.logits(model, torch.from_numpy(toks))
    _close(got, want, 1e-4)


def test_paged_decode_matches_contiguous(pair):
    """Paged prefill and decode (a shuffled pool, the states per slot)
    against the contiguous cache, as the reference's test_paged_serving
    hybrid case (fp32, 1e-5)."""
    _, _, model = pair
    cfg = model.cfg
    rng = np.random.default_rng(4)
    B, plen, steps, bs, mb = 2, 9, 3, 8, 4
    toks = torch.from_numpy(rng.integers(3, cfg.vocab_size,
                                         (B, plen)).astype(np.int32))
    cache = hybrid.init_cache(cfg, B, mb * bs, device="cpu")
    lg_c, cache = hybrid.prefill(model, toks, cache)
    pool = hybrid.init_paged_cache(cfg, B * mb + 1, bs, device="cpu",
                                   batch=B)
    tables = torch.from_numpy(
        rng.permutation(B * mb).reshape(B, mb).astype(np.int32))
    lg_p, pool = hybrid.prefill(model, toks, pool, block_tables=tables,
                                cache_index=torch.zeros(B, dtype=torch.int32))
    _close(lg_p[:, plen - 1:plen], lg_c, 1e-5)
    tok = lg_c[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    lengths = torch.full((B,), plen, dtype=torch.int32)
    for t in range(steps):
        lg_c, cache = hybrid.decode_step(model, tok, cache, plen + t)
        lg_p, pool = hybrid.decode_step(model, tok, pool, lengths,
                                        block_tables=tables)
        _close(lg_p, lg_c, 1e-5)
        tok = lg_c[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        lengths = lengths + 1


def test_bridge_weight_count_and_registry():
    jcfg, _, params_np = _jax_init(True)
    cfg = port_cfg(jcfg)
    model = from_jax_params(params_np, cfg, device="cpu")
    n_ref = sum(int(np.asarray(x).size) for x in jax.tree.leaves(params_np))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    assert get_model(cfg) is hybrid
    short = dict(params_np, final_norm=params_np["final_norm"][:-1])
    with pytest.raises((ValueError, RuntimeError)):
        from_jax_params(short, cfg, device="cpu")
    # the published config: ~2.4 B parameters, 54 layers in 9 groups
    full = hybrid.HybridModel(get_config("zamba2-2.7b"), device="meta")
    assert 2.3e9 < sum(p.numel() for p in full.parameters()) < 2.6e9
    assert hybrid.n_groups(full.cfg) == 9


def test_init_and_refusals():
    cfg = port_cfg(get_smoke_config("zamba2_2p7b"))
    model = hybrid.init(cfg, device="cpu")
    m = model.layers[0].mamba
    H = ssm.n_heads(cfg)
    assert torch.allclose(m.A_log, torch.log(torch.arange(1.0, H + 1)))
    assert torch.equal(m.D, torch.ones(H)) and not m.dt_bias.any()
    toks = torch.zeros((1, 5), dtype=torch.int32)
    assert torch.isfinite(hybrid.logits(model, toks)).all()
    with pytest.raises(NotImplementedError):
        T.init(cfg, device="cpu")            # the transformer refuses it
    with pytest.raises(NotImplementedError):
        hybrid.HybridModel(cfg.replace(ssm_version=1), device="meta")
    with pytest.raises(ValueError):
        hybrid.HybridModel(cfg.replace(hybrid_attn_every=3), device="meta")
    # training is ported: the loss of the reference's form, aux 0
    total, metrics = hybrid.loss(model, {"tokens": toks, "targets": toks})
    assert torch.isfinite(total) and total > 0
    assert set(metrics) == {"ce", "loss", "aux"} and metrics["aux"] == 0
