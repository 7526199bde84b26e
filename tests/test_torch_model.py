"""PyTorch port, model: weights bridged from JAX give the JAX model's logits.

Configs: the JAX serving tests' ``_tiny_gqa`` (Yi-6B family, 2 layers), the
gemma2 smoke config with ``dsa=None`` and ``sliding_window=16`` (local /
global layers whose window really masks at these lengths, attention and
final softcaps, tied gemma-scaled embeddings, gelu), and a variant with
``qk_norm``, ``first_k_dense=1``, G=2 and relu2; the GLM-5 smoke MLA
geometry without experts (``mla``: latent ``c``/``kr`` caches, absorbed
decode through K3/K4's plain versions), and the GLM-5 smoke MLA + MoE config
(``glm5_moe``: one dense-MLP MLA layer, then an MLA layer with 4 routed
experts top-2 plus a shared expert), both with ``dsa=None, mtp=None``.
Logits agree with rtol 1e-4 in fp32 on contiguous and on paged caches
(shuffled tables, a second span at ``starts > 0`` starting mid-block), and
the paged pools hold the same values as the reference's, in the same
layer-major layout.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import paging as jpaging
from repro.models import get_model
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.core import paging as tpaging
from repro_torch.models import transformer as T

RTOL, ATOL = 1e-4, 1e-5


def _cfg(name):
    if name in ("mla", "glm5_moe"):
        glm5 = get_smoke_config("glm5_744b").replace(dsa=None, mtp=None,
                                                     moe_impl="dense")
        return glm5 if name == "glm5_moe" else glm5.replace(
            num_experts=0, num_shared_experts=0)
    if name == "gemma2":
        return get_smoke_config("gemma2_2b").replace(dsa=None,
                                                     sliding_window=16)
    tiny = get_smoke_config("yi_6b").replace(
        d_model=128, num_heads=2, num_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256, dsa=None)
    if name == "tiny_gqa":
        return tiny
    return tiny.replace(num_heads=4, qk_norm=True, first_k_dense=1,
                        num_layers=3, mlp_activation="relu2")


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


@pytest.fixture(scope="module",
                params=["tiny_gqa", "gemma2", "qknorm_fk", "mla", "glm5_moe"])
def pair(request):
    jcfg = _cfg(request.param)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, params)
    model = from_jax_params(params_np, port_cfg(jcfg), device="cpu")
    return jcfg, params, params_np, model


def _jit(fn, cfg):
    """The reference function with ``cfg`` bound, jitted once per shape."""
    return jax.jit(functools.partial(fn, cfg=cfg))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=RTOL,
                               atol=ATOL)


def test_bridge_round_trip(pair):
    jcfg, params, params_np, model = pair
    P = len(jcfg.attention_pattern)
    for i, blk in enumerate(model.layers):
        if i < jcfg.first_k_dense:
            src, g = params_np[f"dense_{i}"], None
        else:
            g, j = divmod(i - jcfg.first_k_dense, P)
            src = params_np[f"slot{j}"]
        pick = (lambda a: a) if g is None else (lambda a: a[g])
        wq = "wq_a" if jcfg.attention_type == "mla" else "wq"
        ffn = "moe" if hasattr(blk, "moe") else "mlp"
        assert ffn in src                 # MoE exactly where the reference
        np.testing.assert_array_equal(getattr(blk.attn, wq).numpy(),
                                      pick(src["attn"][wq]))
        np.testing.assert_array_equal(getattr(blk, ffn).w_down.numpy(),
                                      pick(src[ffn]["w_down"]))
        np.testing.assert_array_equal(blk.attn_norm.numpy(),
                                      pick(src["attn_norm"]))
    np.testing.assert_array_equal(model.embed.embedding.numpy(),
                                  params_np["embed"]["embedding"])
    toks = np.random.default_rng(0).integers(3, jcfg.vocab_size, (2, 9))
    logits = _jit(lambda p, t, cfg: get_model(cfg).logits(p, t, cfg), jcfg)
    want = logits(params, jnp.asarray(toks, jnp.int32))
    _close(model(torch.from_numpy(toks)).numpy(), want)


def test_bridge_rejects_foreign_leaves(pair):
    jcfg, _, params_np, model = pair
    extra = dict(params_np, mtp={"w": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError):
        from_jax_params(extra, model.cfg, device="cpu")


def test_contiguous_prefill_decode_matches_jax(pair):
    jcfg, params, _, model = pair
    jm = get_model(jcfg)
    rng = np.random.default_rng(1)
    Bn, plen, steps, T_max = 2, 20, 3, 32
    toks = rng.integers(3, jcfg.vocab_size, (Bn, plen)).astype(np.int32)
    prefill = _jit(lambda p, t, c, cfg: jm.prefill(p, t, cfg, c), jcfg)
    decode = _jit(lambda p, t, c, i, cfg: jm.decode_step(p, t, cfg, c, i),
                  jcfg)
    jc, _ = jm.init_cache(jcfg, Bn, T_max)
    jl, jc = prefill(params, jnp.asarray(toks), jc)
    tc = T.init_cache(model.cfg, Bn, T_max, device="cpu")
    tl, tc = T.prefill(model, torch.from_numpy(toks), tc)
    _close(tl.numpy(), jl)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for t in range(steps):
        jl, jc = decode(params, jnp.asarray(tok), jc,
                        jnp.asarray(plen + t, jnp.int32))
        tl, tc = T.decode_step(model, torch.from_numpy(tok), tc, plen + t)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_paged_spans_and_decode_match_jax(pair, impl):
    jcfg, params, _, model = pair
    jm = get_model(jcfg)
    rng = np.random.default_rng(2)
    Bn, bs, mb, steps = 2, 8, 5, 3
    spans = [13, 9]                       # the second starts mid-block
    nb = Bn * mb + 1
    toks = rng.integers(3, jcfg.vocab_size,
                        (Bn, sum(spans))).astype(np.int32)
    tables = rng.permutation(nb - 1)[:Bn * mb].reshape(Bn, mb) \
        .astype(np.int32)
    prefill = _jit(lambda p, t, c, bt, ci, cfg: jm.prefill(
        p, t, cfg, c, block_tables=bt, cache_index=ci), jcfg)
    decode = _jit(lambda p, t, c, ln, bt, cfg: jm.decode_step(
        p, t, cfg, c, ln, block_tables=bt), jcfg)
    jpool, _ = jm.init_paged_cache(jcfg, nb, bs)
    tpool = T.init_paged_cache(model.cfg, nb, bs, device="cpu")
    tt = torch.from_numpy(tables)
    start = 0
    for S in spans:
        st = np.full((Bn,), start, np.int32)
        jl, jpool = prefill(params, jnp.asarray(toks[:, start:start + S]),
                            jpool, jnp.asarray(tables), jnp.asarray(st))
        tl, tpool = T.prefill(model,
                              torch.from_numpy(toks[:, start:start + S]),
                              tpool, block_tables=tt,
                              cache_index=torch.from_numpy(st),
                              paged_impl=impl)
        _close(tl.numpy(), jl)            # every position's logits
        start += S
    lengths = np.full((Bn,), start, np.int32)
    tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
    for _ in range(steps):
        jl, jpool = decode(params, jnp.asarray(tok), jpool,
                           jnp.asarray(lengths), jnp.asarray(tables))
        tl, tpool = T.decode_step(model, torch.from_numpy(tok), tpool,
                                  torch.from_numpy(lengths),
                                  block_tables=tt, paged_impl=impl)
        _close(tl.numpy(), jl)
        tok = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        lengths = lengths + 1
    # same layer-major pools, leaf for leaf
    assert set(tpool) == set(jpool)
    for name, leaves in tpool.items():
        for k, v in leaves.items():
            assert tuple(v.shape) == jpool[name][k].shape
            _close(v.numpy(), jpool[name][k])


def test_models_reject_configs_they_cannot_serve():
    base = port_cfg(_cfg("tiny_gqa"))
    from repro_torch.configs.base import DSAConfig, MLAConfig, MTPConfig
    mla = base.replace(attention_type="mla",
                       mla=MLAConfig(q_lora_dim=32, kv_lora_dim=16,
                                     qk_rope_dim=8, qk_nope_dim=16,
                                     v_head_dim=16))
    moe = base.replace(family="moe", num_experts=4, experts_per_token=2,
                       moe_d_ff=32, num_shared_experts=1, first_k_dense=1)
    # served now: MLA attention, MoE FFNs, both together, DSA (either
    # selector, either top-k; the block selector with one block a query
    # block too) on any of them, and the MTP head (shared or not)
    for cfg in (mla, moe, mla.replace(family="moe", num_experts=4,
                                      experts_per_token=2, moe_d_ff=32),
                base.replace(dsa=DSAConfig()), mla.replace(dsa=DSAConfig()),
                moe.replace(dsa=DSAConfig()),
                base.replace(dsa=DSAConfig(selector="block")),
                moe.replace(dsa=DSAConfig(selector="block", top_k=128)),
                mla.replace(dsa=DSAConfig(deterministic_topk=False)),
                base.replace(dsa=DSAConfig(deterministic_topk=False,
                                           selector="block")),
                base.replace(mtp=MTPConfig()),
                moe.replace(mtp=MTPConfig(share_params=False))):
        T.init(cfg, device="cpu")
    bad = [base.replace(family="hybrid")]
    for cfg in bad:
        with pytest.raises(NotImplementedError):
            T.init(cfg, device="cpu")
    with pytest.raises(ValueError):               # no such selector
        T.init(base.replace(dsa=DSAConfig(selector="blocks")), device="cpu")
    with pytest.raises(ValueError):               # a router with no top-k
        T.init(base.replace(num_experts=4), device="cpu")
    from repro_torch.models import encdec
    from repro_torch.models import get_model as port_get_model
    assert port_get_model(base.replace(family="vlm")) is T
    assert port_get_model(base.replace(family="audio")) is encdec
    with pytest.raises(NotImplementedError):      # no such family
        port_get_model(base.replace(family="retnet"))


# ---------------------------------------------------------------------------
# paged primitives (in place), mirrored from the reference's pool tests
# ---------------------------------------------------------------------------

def test_paged_update_view_matches_contiguous_random_fill():
    rng = np.random.default_rng(0)
    Bn, mb, bs, H, dh = 3, 4, 8, 2, 16
    Tn = mb * bs
    contiguous = rng.standard_normal((Bn, Tn, H, dh)).astype(np.float32)
    nb = Bn * mb + 1
    tables = torch.from_numpy(rng.permutation(nb - 1)[:Bn * mb]
                              .reshape(Bn, mb).astype(np.int32))
    pool = torch.zeros((nb, bs, H, dh))
    order = rng.permutation(Tn)
    for s in range(0, Tn, 8):
        pos = np.sort(order[s:s + 8])
        positions = torch.from_numpy(np.tile(pos, (Bn, 1)).astype(np.int32))
        out = tpaging.paged_update(pool, torch.from_numpy(contiguous[:, pos]),
                                   tables, positions)
        assert out is pool                             # written in place
    np.testing.assert_array_equal(tpaging.paged_view(pool, tables).numpy(),
                                  contiguous)


def test_copy_block_strided_matches_jax():
    rng = np.random.default_rng(1)
    L, nb, bs, f = 3, 9, 4, 6
    leaf = rng.standard_normal((L * nb, bs, f)).astype(np.float32)
    want = jpaging.copy_block_strided(jnp.asarray(leaf), jnp.int32(2),
                                      jnp.int32(7), nb)
    t = torch.from_numpy(leaf.copy())
    assert tpaging.copy_block_strided(t, 2, 7, nb) is t
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    want = jpaging.copy_block(jnp.asarray(leaf), 1, 5)
    t = torch.from_numpy(leaf.copy())
    np.testing.assert_array_equal(tpaging.copy_block(t, 1, 5).numpy(),
                                  np.asarray(want))
