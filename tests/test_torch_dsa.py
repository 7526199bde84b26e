"""PyTorch port, DSA: K5/K6, top-k and sparse attention (the model and the
engine are in ``test_torch_dsa_model.py``).

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
  indexer's query and head weights, 2e-5 (the indexer's 1e-4).
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
from repro_torch.bridge import from_jax_params
from repro_torch.configs.base import ModelConfig as PortConfig
from repro_torch.core import dsa as tdsa
from repro_torch.core import paging as tpaging
from repro_torch.kernels.paged_attention import kernel as K5
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import prefill as K6
from repro_torch.kernels.paged_attention import ref as tref
from repro_torch.layers import attention as tattn
from repro_torch.models import transformer as T

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
