"""PyTorch port, K7 lightning indexer and the training side of DSA, against
the JAX package (the CUDA kernel's own cases are in
``test_torch_kernels_cuda.py``).

Numpy-seeded inputs go through both packages in fp32:

* the plain K7 (``kernels.lightning_indexer.ref.reference``, what the
  wrapper runs on CPU tensors) against the Pallas kernel in interpret mode
  and against its ``ref.reference``, S and T not multiples of the 128
  blocks; atol/rtol 2e-5;
* ``core.dsa.indexer_scores`` (the autograd Function: K7 forward, a plain
  backward) and its gradients of the indexer weights, the hiddens and the
  keys against ``jax.grad`` of the reference's ``indexer_scores``, with
  exact zeros among the dot products (ReLU's gradient there is 0 in both);
  rtol 1e-4, atol 1e-5 of the largest |value| (fp32 sums of thousands of
  terms in another order);
* ``dsa_attention(with_indexer_loss=True)`` at the Yi-6B smoke config's DSA
  (top-k 64 of up to 256 keys, 2 indexer heads, q_chunk 128 < S): the
  output, the indexer KL and the gradients of a loss on both (q, k, v, the
  hiddens, the indexer weights) against the reference's; and the same with
  S not a multiple of q_chunk (the reference takes one block there, the
  port chunks; the KL is the same mean); the same tolerance;
* ``indexer_distill_loss`` against the reference's;
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import dsa as jdsa
from repro.kernels.lightning_indexer import kernel as jk7
from repro.kernels.lightning_indexer import ref as jref7
from repro_torch.core import dsa as tdsa
from repro_torch.kernels.lightning_indexer import kernel as K7

RTOL, ATOL = 1e-4, 1e-5


def _close(got, want):
    """rtol 1e-4, atol 1e-5 of max(1, max |want|)."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(want).max()))


def _qwk(seed, B, S, T, Hi, Di):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hi * Di), np.float32)
    w = rng.standard_normal((B, S, Hi), np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return q, w.astype(np.float32), rng.standard_normal((B, T, Di), np.float32)


@pytest.mark.parametrize("S,T,Hi,Di", [(150, 333, 4, 32), (64, 200, 2, 16)])
def test_plain_matches_pallas_and_reference(S, T, Hi, Di):
    q, w, k = _qwk(0, 2, S, T, Hi, Di)
    got = K7.lightning_indexer(*map(torch.from_numpy, (q, w, k)), heads=Hi,
                               head_dim=Di).numpy()
    jq, jw, jk = map(jnp.asarray, (q, w, k))
    pallas = jk7.lightning_indexer(jq, jw, jk, heads=Hi, head_dim=Di,
                                   interpret=True)
    ref = jref7.reference(jq, jw, jk, heads=Hi, head_dim=Di)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5, rtol=2e-5)


def _dsa_setup(seed=0):
    """The Yi-6B smoke config's DSA (top-k 64, 2 heads x 16) and a random
    indexer, as JAX params and the port's ``Indexer``."""
    from repro_torch.configs.base import DSAConfig, ModelConfig
    jcfg = get_smoke_config("yi_6b")
    d = jcfg.dsa
    cfg = ModelConfig(d_model=jcfg.d_model, num_heads=4, num_kv_heads=2,
                      head_dim=32, dsa=DSAConfig(
                          index_heads=d.index_heads,
                          index_head_dim=d.index_head_dim, top_k=d.top_k))
    rng = np.random.default_rng(seed)
    D = cfg.d_model
    params = {"wq_idx": rng.standard_normal(
                  (D, d.index_heads * d.index_head_dim), np.float32) * 0.06,
              "wk_idx": rng.standard_normal((D, d.index_head_dim),
                                            np.float32) * 0.06,
              "w_head": rng.standard_normal((D, d.index_heads),
                                            np.float32) * 0.02}
    idx = tdsa.Indexer(cfg, dtype=torch.float32)
    with torch.no_grad():
        for n, a in params.items():
            getattr(idx, n).copy_(torch.from_numpy(a))
    idx.requires_grad_(True)
    return jcfg, cfg, params, idx


def test_indexer_scores_grads_match_jax():
    jcfg, cfg, params, idx = _dsa_setup()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, cfg.d_model), np.float32)
    kv = rng.standard_normal((2, 70, cfg.d_model), np.float32)
    g = rng.standard_normal((2, 40, 70), np.float32)

    def jfn(p, x, kv):
        s = jdsa.indexer_scores(p, x, jdsa.indexer_keys(p, kv, jcfg.dsa),
                                jcfg.dsa)
        return jnp.sum(s * g), s

    (_, js), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        params, x, kv)
    assert (np.asarray(js) == 0).any()       # ReLU zeros are exercised
    tx, tkv = (torch.from_numpy(a).requires_grad_() for a in (x, kv))
    s = tdsa.indexer_scores(idx, tx, tdsa.indexer_keys(idx, tkv), cfg.dsa)
    (s * torch.from_numpy(g)).sum().backward()
    _close(s.detach().numpy(), js)
    for n in params:
        _close(getattr(idx, n).grad.numpy(), jg[0][n])
    _close(tx.grad.numpy(), jg[1])
    _close(tkv.grad.numpy(), jg[2])


@pytest.mark.parametrize("S", [256, 200])
def test_dsa_attention_with_indexer_loss_matches_jax(S):
    jcfg, cfg, params, idx = _dsa_setup(2)
    B, H, KVH, dh = 2, 4, 2, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, dh), np.float32)
    k = rng.standard_normal((B, S, KVH, dh), np.float32)
    v = rng.standard_normal((B, S, KVH, dh), np.float32)
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    g = rng.standard_normal((B, S, H, dh), np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))

    def jfn(p, q, k, v, x):
        out, kl = jdsa.dsa_attention(
            p, q, k, v, x, jdsa.indexer_keys(p, x, jcfg.dsa), pos, pos, jcfg,
            q_chunk=128, with_indexer_loss=True)
        return jnp.sum(out * g) + 3.0 * kl, (out, kl)

    (_, (jout, jkl)), jg = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3, 4), has_aux=True)(params, q, k, v, x)
    tq, tk, tv, tx = (torch.from_numpy(a).requires_grad_()
                      for a in (q, k, v, x))
    tpos = torch.from_numpy(np.ascontiguousarray(pos))
    out, kl = tdsa.dsa_attention(idx, tq, tk, tv, tx,
                                 tdsa.indexer_keys(idx, tx), tpos, tpos, cfg,
                                 q_chunk=128, with_indexer_loss=True)
    ((out * torch.from_numpy(g)).sum() + 3.0 * kl).backward()
    _close(out.detach().numpy(), jout)
    np.testing.assert_allclose(float(kl.detach()), float(jkl), rtol=RTOL)
    for n in params:
        _close(getattr(idx, n).grad.numpy(), jg[0][n])
    for got, want in zip((tq, tk, tv, tx), jg[1:]):
        _close(got.grad.numpy(), want)


def test_indexer_distill_loss_matches_jax():
    rng = np.random.default_rng(4)
    scores = rng.standard_normal((2, 9, 12), np.float32)
    probs = rng.random((2, 9, 12)).astype(np.float32)
    mask = np.tril(np.ones((9, 12), bool))[None].repeat(2, 0)
    mask[1, 0] = False                        # a query with no valid key
    want = jdsa.indexer_distill_loss(scores, probs, mask)
    got = tdsa.indexer_distill_loss(*map(torch.from_numpy,
                                         (scores, probs, mask)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)

