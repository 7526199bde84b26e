"""PyTorch port, DSA: K5/K6, top-k, sparse attention, the model and the engine.

Every case feeds the same numpy-seeded inputs (or weights bridged from the
JAX model) to the reference and to the port, in fp32:

* the plain K5 (``paged_indexer_scores_plain``) and K6
  (``paged_prefill_indexer_plain``) — what the kernel wrappers run on CPU
  tensors — against the Pallas kernels in interpret mode and both packages'
  gather oracles, on the positions the selector reads; dead blocks must be
  NEG_INF (<= -1e29) as in the Pallas kernels; atol/rtol 2e-5;
* ``paged_take``; ``select_topk`` on scores with exact ties (small
  integers, exact zeros, masked runs), ``idx`` and ``valid`` equal element
  for element to ``jax.lax.top_k``'s;
* ``sparse_token_attention``, ``dsa_attention`` (one chunk, and ragged
  chunks: S not a multiple of the chunk), ``dsa_decode_paged`` and
  ``dsa_prefill_paged`` (``kernel`` and ``ref``), 2e-5;
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

* ``select_topk_blocks`` ids and validity element for element against the
  reference's, with ties at NEG_INF (wholly masked blocks), at -inf (the
  reference's fp32 mean of a block with two or more masked entries
  overflows, so no diagonal block is ever valid) and among equal scores,
  under causal, kv_len and window masks;
* block-branch ``dsa_attention`` (blocks of 128, top-k 256) at S = 256
  (one block-branch chunk), 300 (the reference takes the token branch for
  all 300 queries) and 384 (one block-branch chunk of three query
  blocks, not a multiple of the 256-query chunk), with and without the
  indexer loss: values, the loss and the gradients of q, k, v and the
  indexer's query and head weights, 2e-5 (the indexer's 1e-4);
* Yi-6B smoke and GLM-5 smoke (MTP head on) logits with
  ``selector="block"`` at S = 96 (the block branch) and 100 (the token
  branch), rtol 1e-4;
* the port's engine against JAX's ``ContinuousEngine`` with the block
  selector (spans of 16 reach K8's plain version; whole-prompt spans of
  32 and 40), greedy tokens equal, ``kernel`` and ``ref`` alike.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.configs.base import DSAConfig as JaxDSAConfig
from repro.core import dsa as jdsa
from repro.core import paging as jpaging
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.kernel import \
    paged_indexer_scores_kernel as jax_indexer
from repro.kernels.paged_attention.prefill import \
    paged_prefill_indexer as jax_prefill_indexer
from repro.layers import attention as jattn
from repro.models import get_model
from repro.serving import ContinuousEngine as JaxEngine
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxOracle
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import DSAConfig
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.core import dsa as tdsa
from repro_torch.core import paging as tpaging
from repro_torch.kernels.paged_attention import kernel as K5
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import prefill as K6
from repro_torch.kernels.paged_attention import ref as tref
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as T
from repro_torch.serving import ContinuousEngine, Request

TOL = 2e-5
RTOL_MODEL, ATOL_MODEL = 1e-4, 1e-5
MARGIN = 1e-3


def port_cfg(jcfg):
    return PortConfig(**{f.name: getattr(jcfg, f.name)
                         for f in dataclasses.fields(PortConfig)})


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(a, b, rtol=TOL, atol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# K5 / K6: plain versions vs the Pallas kernels and the gather oracles
# ---------------------------------------------------------------------------

def _indexer_inputs(seed, Hi, Di, bs, mb, B=5, S=None):
    """A k_idx pool with a trash block at the end, disjoint shuffled tables,
    queries and softmaxed head weights; decode row 0 is an idle slot (all
    trash, length 0)."""
    rng = np.random.default_rng(seed)
    nb = B * mb + 1
    kp = rng.standard_normal((nb, bs, Di)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * mb].reshape(B, mb).astype(np.int32)
    lead = (B, Hi) if S is None else (B, S, Hi)
    q = rng.standard_normal(lead + (Di,)).astype(np.float32)
    logits = rng.standard_normal(lead)
    w = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)) \
        .astype(np.float32)
    if S is None:
        tables[0] = nb - 1
        pos = np.asarray([0, 1, bs - 1, bs, mb * bs - 1][:B], np.int32)
    else:
        pos = np.asarray([0, bs - 1, bs + 3, 2, mb * bs - S][:B], np.int32)
    return q, w, kp, tables, pos


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("Hi,Di", [(2, 16), (4, 32)])
def test_plain_indexer_decode_matches_pallas_and_gather(Hi, Di, bs):
    mb = 4
    q, w, kp, tables, lens = _indexer_inputs(0, Hi, Di, bs, mb)
    want = np.asarray(jax_indexer(*_j(q, w, kp, tables, lens), interpret=True))
    got = K5.paged_indexer_scores_plain(*_t(q, w, kp, tables, lens)).numpy()
    assert got.shape == (5, mb * bs) and got.dtype == np.float32
    live = np.arange(mb * bs)[None] <= lens[:, None]
    _close(np.where(live, got, 0.0), np.where(live, want, 0.0))
    dead = np.arange(mb * bs)[None] // bs > lens[:, None] // bs
    assert (got[dead] <= -1e29).all() and (want[dead] <= -1e29).all()
    _close(np.where(dead, 0.0, got), np.where(dead, 0.0, want))
    assert np.isfinite(got[0, :bs]).all()                # the trash row
    # the gather oracles of both packages and the dispatch, on live positions
    want_ref = np.asarray(jref.paged_indexer_reference(
        *_j(q, w, kp, tables, lens)))
    got_ref = tref.paged_indexer_reference(*_t(q, w, kp, tables, lens))
    _close(got_ref.numpy(), want_ref)
    for impl in ("kernel", "ref"):
        got_ops = ops.paged_indexer_scores(*_t(q, w, kp, tables, lens),
                                           impl=impl).numpy()
        _close(np.where(live, got_ops, 0.0), np.where(live, want_ref, 0.0))


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("Hi,Di", [(2, 16), (4, 32)])
def test_plain_indexer_prefill_matches_pallas_and_gather(Hi, Di, bs):
    mb, S, B = 6, 5, 5
    q, w, kp, tables, starts = _indexer_inputs(1, Hi, Di, bs, mb, S=S)
    want = np.asarray(jax_prefill_indexer(
        *_j(q.reshape(B, S * Hi, Di), w.reshape(B, S * Hi), kp, tables,
            starts), heads=Hi, interpret=True))
    got = K6.paged_prefill_indexer_plain(
        *_t(q.reshape(B, S * Hi, Di), w.reshape(B, S * Hi), kp, tables,
            starts), heads=Hi).numpy()
    assert got.shape == (B, S, mb * bs)
    qpos = starts[:, None] + np.arange(S)[None]
    live = np.arange(mb * bs)[None, None] <= qpos[:, :, None]
    _close(np.where(live, got, 0.0), np.where(live, want, 0.0))
    dead = np.repeat((np.arange(mb * bs)[None] // bs
                      > (starts + S - 1)[:, None] // bs)[:, None], S, 1)
    assert (got[dead] <= -1e29).all() and (want[dead] <= -1e29).all()
    _close(np.where(dead, 0.0, got), np.where(dead, 0.0, want))
    want_ref = np.asarray(jref.paged_indexer_prefill_reference(
        *_j(q, w, kp, tables, starts)))
    got_ref = tref.paged_indexer_prefill_reference(
        *_t(q, w, kp, tables, starts))
    _close(got_ref.numpy(), want_ref)
    for impl in ("kernel", "ref"):
        got_ops = ops.paged_indexer_prefill(*_t(q, w, kp, tables, starts),
                                            impl=impl).numpy()
        _close(np.where(live, got_ops, 0.0), np.where(live, want_ref, 0.0))


def test_indexer_kernel_argument_check_refuses_cpu_and_bad_shapes():
    q, w, kp, tables, lens = _t(*_indexer_inputs(2, 2, 16, 8, 4))
    with pytest.raises(ValueError):                   # not a CUDA tensor
        K5.check_cuda_indexer_args(q, w, kp, tables, lens, 2)
    with pytest.raises(ValueError):                   # S*Hi not a multiple
        K6.paged_prefill_indexer_plain(q, w, kp, tables, lens, heads=3)


def test_paged_take_matches_jax():
    rng = np.random.default_rng(3)
    B, bs, mb, f = 3, 8, 4, 5
    nb = B * mb + 1
    pool = rng.standard_normal((nb, bs, 2, f)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * mb].reshape(B, mb).astype(np.int32)
    idx = rng.integers(0, mb * bs, size=(B, 7)).astype(np.int32)
    want = np.asarray(jpaging.paged_take(*_j(pool, tables, idx)))
    got = tpaging.paged_take(*_t(pool, tables, idx)).numpy()
    np.testing.assert_array_equal(got, want)
    view = tpaging.paged_view(*_t(pool, tables)).numpy()
    np.testing.assert_array_equal(got, np.take_along_axis(
        view, idx[..., None, None].astype(np.int64), axis=1))


# ---------------------------------------------------------------------------
# top-k with exact ties, and the sparse attention cores
# ---------------------------------------------------------------------------

def _tied_scores(seed, B=2, S=6, T=40):
    """Small integers (many exact ties), runs of exact zeros, masked runs
    (every masked entry becomes exactly NEG_INF) and causal rows."""
    rng = np.random.default_rng(seed)
    scores = rng.integers(0, 4, size=(B, S, T)).astype(np.float32)
    scores[:, :, 5:15] = 0.0
    scores[0, 1] = 0.0                                    # a row of ties
    mask = rng.random((B, S, T)) > 0.3
    mask[:, :, 20:26] = False
    mask[1, 2] = np.arange(T) <= 3                        # few valid keys
    mask[1, 3] = False                                    # none valid
    return scores, mask


@pytest.mark.parametrize("k", [1, 3, 8, 17, 40, 64])
def test_select_topk_breaks_ties_like_jax(k):
    scores, mask = _tied_scores(4)
    want_idx, want_valid = jdsa.select_topk(*_j(scores, mask), k)
    got_idx, got_valid = tdsa.select_topk(*_t(scores, mask), k)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))


@pytest.mark.parametrize("start,kv_len,window,k", [
    (0, None, 0, 32), (0, None, 0, 64), (24, None, 0, 48),
    (8, 70, 0, 32), (40, None, 24, 32), (0, None, 0, 8)])
def test_select_topk_blocks_matches_jax(start, kv_len, window, k):
    """Query blocks from a per-row start, tied integer scores, masked
    (NEG_INF) and partly masked (-inf) key blocks."""
    bs, B, S, T = 8, 2, 32, 96
    rng = np.random.default_rng(start + k)
    scores = rng.integers(0, 3, size=(B, S, T)).astype(np.float32)
    scores[:, :, 16:40] = 0.0
    pos = (start + np.arange(S, dtype=np.int32))[None].repeat(B, 0)
    kvp = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jm = jattn.attention_mask(jnp.asarray(pos), jnp.asarray(kvp),
                              causal=True, window=window, kv_len=kv_len)
    tm = tattn.attention_mask(torch.from_numpy(pos),
                              torch.from_numpy(np.ascontiguousarray(kvp)),
                              causal=True, window=window, kv_len=kv_len)
    want_idx, want_valid = jdsa.select_topk_blocks(jnp.asarray(scores), jm,
                                                   k, bs)
    got_idx, got_valid = tdsa.select_topk_blocks(torch.from_numpy(scores),
                                                 tm, k, bs)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), np.asarray(want_valid))
    assert not np.asarray(want_valid).all()      # some blocks not valid


def _qkv(seed, B=2, S=24, T=24, H=4, KVH=2, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dh)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_sparse_token_attention_matches_jax(softcap):
    q, k, v = _qkv(5)
    B, S = q.shape[:2]
    rng = np.random.default_rng(6)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    idx = rng.integers(0, S, size=(B, S, 8)).astype(np.int32)
    valid = rng.random((B, S, 8)) > 0.2
    idx[:, :3] = 20                        # causally invalid selections
    want = jdsa.sparse_token_attention(*_j(q, k, v, idx, valid, pos, pos),
                                       softcap=softcap)
    got = tdsa.sparse_token_attention(*_t(q, k, v, idx, valid, pos, pos),
                                      softcap=softcap)
    assert np.isfinite(got.numpy()).all()
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def idx_layer():
    """Layer 0 of the Yi-6B smoke config with DSA (top-k 64, 2 indexer
    heads x 16) in both packages."""
    jcfg = get_smoke_config("yi_6b")
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    jidx = jax.tree.map(lambda a: a[0], params["slot0"]["idx"])
    return jcfg, jidx, model.layers[0].idx, model.cfg


def test_indexer_keys_and_scores_match_jax(idx_layer):
    jcfg, jidx, tidx, cfg = idx_layer
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    xk = rng.standard_normal((2, 13, jcfg.d_model)).astype(np.float32)
    want_k = jdsa.indexer_keys(jidx, jnp.asarray(xk), jcfg.dsa)
    got_k = tdsa.indexer_keys(tidx, torch.from_numpy(xk))
    _close(got_k.detach().numpy(), want_k)
    want = jdsa.indexer_scores(jidx, jnp.asarray(x), want_k, jcfg.dsa)
    got = tdsa.indexer_scores(tidx, torch.from_numpy(x), got_k, cfg.dsa)
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("S,chunk", [(100, 256), (100, 32), (70, 70)])
def test_dsa_attention_matches_jax_chunked_or_not(idx_layer, S, chunk):
    """Chunked (the last chunk ragged) or not, the port gives the JAX
    function's unchunked result (the reference chunks only when S is a
    multiple of its chunk)."""
    jcfg, jidx, tidx, cfg = idx_layer
    H, KVH, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    q, k, v = _qkv(8, B=2, S=S, T=S, H=H, KVH=KVH, dh=dh)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    ki = rng.standard_normal((2, S, jcfg.dsa.index_head_dim)) \
        .astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S)).copy()
    want = jdsa.dsa_attention(jidx, *_j(q, k, v, x, ki, pos, pos), jcfg,
                              q_chunk=0)
    with torch.no_grad():
        got = tdsa.dsa_attention(tidx, *_t(q, k, v, x, ki, pos, pos), cfg,
                                 q_chunk=chunk)
    _close(got.numpy(), want)


@pytest.fixture(scope="module")
def block_idx_layer():
    """Layer 0 of the Yi-6B smoke config with the block selector at the
    reference's block size (128, top-k 256: two blocks a query block)."""
    jcfg = get_smoke_config("yi_6b").replace(dsa=JaxDSAConfig(
        index_heads=2, index_head_dim=16, top_k=256, block_size=128,
        selector="block"))
    params, _ = get_model(jcfg).init(jax.random.key(0), jcfg)
    model = from_jax_params(jax.tree.map(np.asarray, params), port_cfg(jcfg),
                            device="cpu")
    jidx = jax.tree.map(lambda a: a[0], params["slot0"]["idx"])
    return jcfg, jidx, model.layers[0].idx, model.cfg


@pytest.mark.parametrize("S", [256, 300, 384])
@pytest.mark.parametrize("with_loss", [False, True])
def test_block_dsa_attention_matches_jax(block_idx_layer, S, with_loss):
    """The reference's chunking decides the branch: S = 256 and 384 take
    the block branch (one chunk), 300 the token branch for all queries."""
    jcfg, jidx, tidx, cfg = block_idx_layer
    H, KVH, dh = jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim
    q, k, v = _qkv(20 + S, B=1, S=S, T=S, H=H, KVH=KVH, dh=dh)
    rng = np.random.default_rng(S)
    x = rng.standard_normal((1, S, jcfg.d_model)).astype(np.float32)
    ki = rng.standard_normal((1, S, jcfg.dsa.index_head_dim)) \
        .astype(np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    g = rng.standard_normal((1, S, H, dh)).astype(np.float32)

    def jfn(p, q_, k_, v_):
        res = jdsa.dsa_attention(p, q_, k_, v_, jnp.asarray(x),
                                 jnp.asarray(ki), jnp.asarray(pos),
                                 jnp.asarray(pos), jcfg,
                                 with_indexer_loss=with_loss)
        out, kl = res if with_loss else (res, jnp.zeros(()))
        return jnp.sum(out * g) + kl, (out, kl)

    (_, (want, want_kl)), jgrads = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(jidx, *_j(q, k, v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tidx.zero_grad()
    tidx.requires_grad_(True)
    res = tdsa.dsa_attention(tidx, tq, tk, tv, *_t(x, ki, pos, pos), cfg,
                             with_indexer_loss=with_loss)
    got, kl = res if with_loss else (res, torch.zeros(()))
    _close(got.detach().numpy(), want)
    ((got * torch.from_numpy(g)).sum() + kl).backward()
    for t, jg in zip((tq, tk, tv), jgrads[1:]):
        _close(t.grad.numpy(), jg)
    if with_loss:
        np.testing.assert_allclose(float(kl.detach()), float(want_kl),
                                   rtol=1e-5)
        for name in ("wq_idx", "w_head"):     # k_idx is given: no wk_idx
            _close(getattr(tidx, name).grad.numpy(), jgrads[0][name],
                   rtol=1e-4, atol=1e-4)
    tidx.requires_grad_(False)


def _paged_setup(seed, jcfg, B, mb, bs):
    rng = np.random.default_rng(seed)
    nb = B * mb + 1
    KVH, dh, Di = jcfg.num_kv_heads, jcfg.head_dim, jcfg.dsa.index_head_dim
    kp = rng.standard_normal((nb, bs, KVH, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, KVH, dh)).astype(np.float32)
    kip = rng.standard_normal((nb, bs, Di)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * mb].reshape(B, mb).astype(np.int32)
    return rng, kp, vp, kip, tables


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_dsa_decode_paged_matches_jax(idx_layer, impl):
    jcfg, jidx, tidx, cfg = idx_layer
    B, mb, bs = 4, 8, 16
    rng, kp, vp, kip, tables = _paged_setup(10, jcfg, B, mb, bs)
    lens = np.asarray([0, 17, 70, mb * bs - 1], np.int32)   # top-k 64 < 71
    q = rng.standard_normal((B, 1, jcfg.num_heads, jcfg.head_dim)) \
        .astype(np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model)).astype(np.float32)
    qpos = lens[:, None].copy()
    want = jdsa.dsa_decode_paged(jidx, *_j(q, kp, vp, x, kip, tables, lens,
                                           qpos), jcfg)
    with torch.no_grad():
        got = tdsa.dsa_decode_paged(tidx, *_t(q, kp, vp, x, kip, tables, lens,
                                              qpos), cfg, impl=impl)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_dsa_prefill_paged_matches_jax(idx_layer, impl):
    jcfg, jidx, tidx, cfg = idx_layer
    B, mb, bs, S = 3, 8, 16, 37
    rng, kp, vp, kip, tables = _paged_setup(11, jcfg, B, mb, bs)
    starts = np.asarray([0, bs + 5, mb * bs - S], np.int32)
    pos = starts[:, None] + np.arange(S, dtype=np.int32)[None]
    q = rng.standard_normal((B, S, jcfg.num_heads, jcfg.head_dim)) \
        .astype(np.float32)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    want = jdsa.dsa_prefill_paged(jidx, *_j(q, kp, vp, x, kip, tables, pos),
                                  jcfg)
    with torch.no_grad():
        for chunk in (256, 16):
            got = tdsa.dsa_prefill_paged(
                tidx, *_t(q, kp, vp, x, kip, tables, pos), cfg, impl=impl,
                q_chunk=chunk)
            _close(got.numpy(), want)


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
