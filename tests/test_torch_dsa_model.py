"""PyTorch port, DSA in the model and the engine (the kernels, top-k and
sparse attention are in ``test_torch_dsa.py``, whose helpers this file
shares).

Every case feeds the same weights bridged from the JAX model and
numpy-seeded inputs to the reference and to the port, in fp32:

* model logits without a cache, and paged prefill + decode against the
  contiguous cache (rtol 1e-4), for the Yi-6B smoke config with DSA (top-k
  64 of up to 100 positions, 2 indexer heads), the GLM-5 smoke config with
  DSA and MoE (``mtp=None``: MLA layers write ``k_idx`` and read none) and
  the gemma2 smoke config (window 16 on the local layers, DSA and ``k_idx``
  on the global ones);
* the port's ``ContinuousEngine`` on tiny GQA + DSA and GLM-5 + DSA + MoE
  configs, with prompts longer than ``top_k``, mid-flight admission, a
  radix hit with a COW fork and chunked prefill: JAX's ``ServingEngine``
  tokens wherever the top-2 margin is >= 1e-3; inside the port ``kernel``
  vs ``ref`` and cache on vs off identical.

The block selector (K8's path):

* Yi-6B smoke and GLM-5 smoke (MTP head on) logits with
  ``selector="block"`` at S = 96 (the block branch) and 100 (the token
  branch), rtol 1e-4;
* the port's engine against JAX's ``ContinuousEngine`` with the block
  selector (spans of 16 reach K8's plain version; whole-prompt spans of
  32 and 40), greedy tokens equal, ``kernel`` and ``ref`` alike.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DSAConfig as JaxDSAConfig
from repro.models import get_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import DSAConfig
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousEngine, Request
from test_torch_dsa import ATOL_MODEL, MARGIN, RTOL_MODEL, _close, port_cfg
from _torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the model: logits without a cache, paged vs contiguous
# ---------------------------------------------------------------------------

def _model_cfg(name):
    block = JaxDSAConfig(index_heads=2, index_head_dim=16, top_k=64,
                         block_size=16, selector="block")
    if name == "yi_dsa":
        return get_smoke_config("yi_6b")
    if name == "yi_block":
        return get_smoke_config("yi_6b").replace(dsa=block)
    if name == "gemma2_dsa":       # DSA on the global layers only
        return get_smoke_config("gemma2_2b").replace(sliding_window=16)
    if name == "glm5_block_mtp":   # the MTP head bridged too, unused here
        return get_smoke_config("glm5_744b").replace(moe_impl="dense",
                                                     dsa=block)
    return get_smoke_config("glm5_744b").replace(mtp=None, moe_impl="dense")


def _pair(name):
    jcfg = _model_cfg(name)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    return jcfg, params, model


@pytest.fixture(scope="module",
                params=["yi_dsa", "glm5_dsa_moe", "gemma2_dsa"])
def pair(request):
    return _pair(request.param)


def _logits_match(jcfg, params, model, S=100):
    toks = np.random.default_rng(12).integers(3, jcfg.vocab_size, (2, S))
    want = get_model(jcfg).logits(params, jnp.asarray(toks, jnp.int32), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    _close(got.numpy(), want, rtol=RTOL_MODEL, atol=ATOL_MODEL)


def test_logits_without_cache_match_jax(pair):
    _logits_match(*pair)


@pytest.mark.parametrize("name,lengths", [("yi_block", (96, 100)),
                                          ("glm5_block_mtp", (96,))])
def test_block_selector_logits_match_jax(name, lengths):
    """The block selector without a cache (S = 96: one block-branch chunk
    of six 16-query blocks; S = 100: the token branch)."""
    jcfg, params, model = _pair(name)
    for S in lengths:
        _logits_match(jcfg, params, model, S=S)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_paged_prefill_decode_match_contiguous_and_jax(pair, impl):
    """Prompt spans at per-row starts (the second mid-block) past top-k,
    then decode steps: paged == contiguous in the port, and == JAX's paged
    logits; the pools hold JAX's values, ``k_idx`` included."""
    jcfg, params, model = pair
    jm = get_model(jcfg)
    assert any("k_idx" in leaves for leaves in
               T.init_cache(model.cfg, 1, 8, device="cpu").values())
    rng = np.random.default_rng(13)
    Bn, bs, mb, steps = 2, 16, 6, 3
    spans = [70, 9]
    plen = sum(spans)
    nb = Bn * mb + 1
    toks = rng.integers(3, jcfg.vocab_size, (Bn, plen)).astype(np.int32)
    tables = rng.permutation(nb - 1)[:Bn * mb].reshape(Bn, mb) \
        .astype(np.int32)
    jpool, _ = jm.init_paged_cache(jcfg, nb, bs)
    tpool = T.init_paged_cache(model.cfg, nb, bs, device="cpu")
    tc = T.init_cache(model.cfg, Bn, mb * bs, device="cpu")
    tt = torch.from_numpy(tables)
    tl_c, tc = T.prefill(model, torch.from_numpy(toks), tc)
    start = 0
    for S in spans:
        st = np.full((Bn,), start, np.int32)
        jl, jpool = jm.prefill(params, jnp.asarray(toks[:, start:start + S]),
                               jcfg, jpool, block_tables=jnp.asarray(tables),
                               cache_index=jnp.asarray(st))
        tl, tpool = T.prefill(model,
                              torch.from_numpy(toks[:, start:start + S]),
                              tpool, block_tables=tt,
                              cache_index=torch.from_numpy(st),
                              paged_impl=impl)
        _close(tl.numpy(), jl, rtol=RTOL_MODEL, atol=ATOL_MODEL)
        start += S
    _close(tl_c.numpy(), tl[:, -1:].numpy(), rtol=RTOL_MODEL, atol=ATOL_MODEL)
    lengths = np.full((Bn,), plen, np.int32)
    tok = tl[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
    for t in range(steps):
        jl, jpool = jm.decode_step(params, jnp.asarray(tok), jcfg, jpool,
                                   jnp.asarray(lengths),
                                   block_tables=jnp.asarray(tables))
        tl, tpool = T.decode_step(model, torch.from_numpy(tok), tpool,
                                  torch.from_numpy(lengths), block_tables=tt,
                                  paged_impl=impl)
        tl_c, tc = T.decode_step(model, torch.from_numpy(tok), tc, plen + t)
        _close(tl.numpy(), jl, rtol=RTOL_MODEL, atol=ATOL_MODEL)
        _close(tl.numpy(), tl_c.numpy(), rtol=RTOL_MODEL, atol=ATOL_MODEL)
        tok = tl[:, -1].argmax(-1)[:, None].numpy().astype(np.int32)
        lengths = lengths + 1
    assert set(tpool) == set(jpool)
    for name, leaves in tpool.items():
        assert set(leaves) == set(jpool[name])
        for k, v in leaves.items():
            _close(v.numpy(), jpool[name][k], rtol=RTOL_MODEL,
                   atol=ATOL_MODEL)


def test_models_reject_dsa_parts_not_ported():
    base = port_cfg(get_smoke_config("yi_6b"))
    T.init(base, device="cpu")                       # the token selector
    for dsa in (DSAConfig(selector="block"),         # 16 blocks of 128
                DSAConfig(selector="block", top_k=128)):     # one block
        T.init(base.replace(dsa=dsa), device="cpu")
    with pytest.raises(NotImplementedError):
        T.init(base.replace(dsa=DSAConfig(deterministic_topk=False)),
               device="cpu")
    with pytest.raises(ValueError, match="selector"):
        T.init(base.replace(dsa=DSAConfig(selector="tokens")), device="cpu")


def test_init_scales_w_head_like_the_reference():
    cfg = port_cfg(get_smoke_config("yi_6b")).replace(d_model=512)
    model = T.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    idx = model.layers[0].idx
    assert abs(idx.w_head.std().item() - 0.02) < 0.004
    assert abs(idx.wq_idx.std().item() - 512 ** -0.5) < 0.004


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine_cfg(name):
    dsa = JaxDSAConfig(index_heads=2, index_head_dim=16, top_k=16,
                       block_size=16)
    if name == "gqa_dsa":
        return get_smoke_config("yi_6b").replace(
            d_model=128, num_heads=4, num_kv_heads=2, head_dim=32, d_ff=256,
            vocab_size=256, dsa=dsa)
    return get_smoke_config("glm5_744b").replace(
        d_model=128, num_heads=2, num_kv_heads=2, d_ff=256, vocab_size=256,
        num_experts=4, num_shared_experts=1, mtp=None, first_k_dense=1,
        moe_impl="dense", dsa=dsa)


def _workload(vocab):
    """Prompts past top-k: a shared 21-token system prompt (ends mid-block)
    with suffixes, an exact duplicate, and unrelated prompts."""
    rng = np.random.default_rng(14)
    sys_p = rng.integers(3, vocab, size=21)
    prompts = [np.concatenate([sys_p, rng.integers(3, vocab, size=n)])
               for n in (11, 19, 4)]
    prompts.append(prompts[0].copy())
    prompts += [rng.integers(3, vocab, size=n) for n in (37, 9)]
    return [p.astype(np.int32) for p in prompts], [5, 7, 4, 5, 6, 3]


def _margin_ok(model, prompt, out):
    seq = torch.from_numpy(np.concatenate([prompt, out[:-1]]).astype(np.int64))
    with torch.no_grad():
        lg = T.logits(model, seq[None])[0, len(prompt) - 1:]
    top2 = lg.topk(2, dim=-1).values
    return bool(((top2[:, 0] - top2[:, 1]) >= MARGIN).all())


@pytest.mark.parametrize("name", ["gqa_dsa", "glm5_dsa_moe"])
def test_engine_with_dsa_matches_jax_oracle(name):
    jcfg = _engine_cfg(name)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    prompts, max_new = _workload(jcfg.vocab_size)
    oracle = [JaxRequest(prompt=p, max_new=m)
              for p, m in zip(prompts, max_new)]
    JaxOracle(jcfg, params, max_batch=1, max_len=64).serve(oracle)
    outs = {}
    for impl, cache, chunk in (("kernel", True, 16), ("ref", True, 16),
                               ("kernel", False, 16), ("kernel", True, None)):
        eng = ContinuousEngine(model.cfg, model, max_batch=2, block_size=8,
                               num_blocks=40, max_len=64, prefill_chunk=chunk,
                               prefix_cache=cache, attn_impl=impl,
                               device="cpu")
        assert "k_idx" in eng.pool["slot0"]
        reqs = [Request(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        eng.serve(reqs)
        assert all(r.status == "ok" for r in reqs)
        outs[(impl, cache, chunk)] = [r.out for r in reqs]
        if cache:      # radix hits with a COW fork, mid-flight admission
            assert eng.stats["cached_tokens"] > 0
            assert eng.stats["cow_forks"] > 0
        assert any(s > 0 for s in eng.stats["admit_steps"])
        assert eng.kv.free_blocks + eng.cached_blocks == eng.kv.num_blocks
    base = outs[("kernel", True, 16)]
    for key, got in outs.items():                  # exact, inside the port
        for a, b in zip(got, base):
            np.testing.assert_array_equal(a, b, err_msg=str(key))
    compared = 0
    for p, got, o in zip(prompts, base, oracle):
        if not _margin_ok(model, p, o.out):
            continue
        compared += 1
        np.testing.assert_array_equal(got, o.out)
    assert compared >= 4


def test_engine_with_block_selector_matches_jax_engine():
    """GQA + DSA with the block selector (blocks of 16, top-k 32): spans of
    16 (chunked prefill) and whole prompts of 32 and 40 through the
    gathered view, the block branch where the span is a multiple of 16;
    the port's engine gives JAX's ``ContinuousEngine`` tokens, on both
    routes, with and without chunked prefill."""
    dsa = JaxDSAConfig(index_heads=2, index_head_dim=16, top_k=32,
                       block_size=16, selector="block")
    jcfg = _engine_cfg("gqa_dsa").replace(dsa=dsa)
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    rng = np.random.default_rng(15)
    prompts = [rng.integers(3, jcfg.vocab_size, size=n).astype(np.int32)
               for n in (32, 40, 9, 48)]
    max_new = [6, 4, 5, 3]
    kw = dict(max_batch=2, block_size=8, num_blocks=40, max_len=64)
    for chunk in (16, None):
        want = [JaxRequest(prompt=p, max_new=m)
                for p, m in zip(prompts, max_new)]
        JaxEngine(jcfg, params, prefill_chunk=chunk, **kw).serve(want)
        for impl in ("kernel", "ref"):
            eng = ContinuousEngine(model.cfg, model, prefill_chunk=chunk,
                                   attn_impl=impl, device="cpu", **kw)
            reqs = [Request(prompt=p, max_new=m)
                    for p, m in zip(prompts, max_new)]
            eng.serve(reqs)
            for a, b in zip(reqs, want):
                np.testing.assert_array_equal(a.out, b.out,
                                              err_msg=f"{impl} {chunk}")
