"""PyTorch port: K9 at head dim 80 and K7 at 8 indexer heads, the shapes
zamba2-2.7b's training runs (its shared block: 32 heads of 80, no GQA; its
DSA retrofit: 8 indexer heads of 64), against the JAX package's Pallas
kernels in interpret mode (both take these shapes there).

* the plain K9 (the wrapper on CPU tensors) at d 80, 32 / 32 heads and
  G 4, causal, window + softcap, q_offset and non-causal, against the
  Pallas ``flash_attention`` and its ``ref.reference``, 2e-5; and
  ``flash_attend`` at d 80, 32 / 32 heads (K9's forward, the plain
  backward recomputed a query chunk at a time), values and gradients
  against ``jax.value_and_grad`` of the reference's ``dense_attention``,
  rtol 1e-4;
* the 3xTF32 tile's arithmetic at d 80 (``test_torch_tile_numerics``'s
  ``tf32_tile_attention``: ten n-tiles of 8 columns, ten k-steps of 8)
  against the Pallas kernel at 1e-5, one TF32 product shown to miss it;
  the bf16 tile's (``test_torch_flash_bf16_numerics``' walk: five k-steps
  of 16) at the bf16 bound, parts 1 and 4;
* the plain K7 at 8 x 64 against the Pallas ``lightning_indexer`` and its
  reference, 2e-5;
* the tensor-core body's arithmetic at 8 heads, one n-tile
  (``test_torch_li_tile_numerics``' 3xTF32 and bf16 forms), against the
  Pallas kernel at 1e-5 (fp32; one TF32 product shown to miss) and at the
  bf16 bound; the wrapper naming that body for 8 heads.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk9
from repro.kernels.flash_attention import ref as jref9
from repro.kernels.lightning_indexer import kernel as jk7
from repro.kernels.lightning_indexer import ref as jref7
from repro.layers.attention import dense_attention as jax_dense_attention
from repro_torch.kernels.flash_attention import kernel as K9
from repro_torch.kernels.lightning_indexer import kernel as K7
from repro_torch.layers.attention import flash_attend
from test_torch_flash_bf16_numerics import bf16_tile_attention
from test_torch_li_tile_numerics import (_inputs, _pallas,
                                         k7_bf16_arithmetic,
                                         k7_tf32_arithmetic)
from test_torch_tile_numerics import _bf16, _bh, tf32_tile_attention
from _torch_threads import one_torch_thread  # noqa: F401

D80_CASES = [
    (32, 32, 70, 70, dict(causal=True)),
    (32, 32, 50, 90, dict(causal=False)),
    (8, 2, 90, 90, dict(causal=True, window=24, softcap=30.0)),
    (8, 2, 40, 100, dict(causal=True, q_offset=60)),
]


def _qkv(seed, Sq, Sk, H, KVH, d=80):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, Sq, H, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KVH, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KVH, d)).astype(np.float32))


def _pallas_k9(q, k, v, G, kw):
    return np.asarray(jk9.flash_attention(
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k, G)), jnp.asarray(_bh(v, G)),
        interpret=True, **kw))


@pytest.mark.parametrize("case", range(len(D80_CASES)))
def test_plain_k9_d80_matches_pallas(case):
    H, KVH, Sq, Sk, kw = D80_CASES[case]
    q, k, v = _qkv(case, Sq, Sk, H, KVH)
    assert 80 in K9.HEAD_DIMS
    got = _bh(K9.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 **kw).numpy())
    want = _pallas_k9(q, k, v, H // KVH, kw)
    ref = np.asarray(jref9.reference(
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k, H // KVH)),
        jnp.asarray(_bh(v, H // KVH)), **kw))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_flash_attend_d80_grads_match_jax():
    S = 150
    q, k, v = _qkv(30, S, S, 32, 32)
    g = np.random.default_rng(31).standard_normal(q.shape).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S), (1, S))

    def jfn(q, k, v):
        out = jax_dense_attention(q, k, v, pos, pos, causal=True)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attend(tq, tk, tv, q_chunk=64)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("case", range(len(D80_CASES)))
def test_tf32_tile_d80_matches_pallas(case):
    H, KVH, Sq, Sk, kw = D80_CASES[case]
    q, k, v = _qkv(10 + case, Sq, Sk, H, KVH)
    want = _pallas_k9(q, k, v, H // KVH, kw)
    G = H // KVH
    args = [torch.from_numpy(x) for x in (_bh(q), _bh(k, G), _bh(v, G))]
    got = tf32_tile_attention(*args, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = tf32_tile_attention(*args, products=1, **kw).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("case", range(len(D80_CASES)))
def test_bf16_tile_d80_matches_pallas(case, parts):
    H, KVH, Sq, Sk, kw = D80_CASES[case]
    q, k, v = (_bf16(torch.from_numpy(x)).numpy()
               for x in _qkv(20 + case, Sq, Sk, H, KVH))
    want = _pallas_k9(q, k, v, H // KVH, kw)
    got = _bh(bf16_tile_attention(*map(torch.from_numpy, (q, k, v)),
                                  parts=parts, **kw).numpy())
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    assert 0.0 < float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("S,T", [(37, 333), (150, 256)])
def test_plain_k7_8x64_matches_pallas(S, T):
    Hi, Di = 8, 64
    q, w, k = _inputs(S + T, 2, S, T, Hi, Di)
    got = K7.lightning_indexer(*map(torch.from_numpy, (q, w, k)), heads=Hi,
                               head_dim=Di).numpy()
    jq, jw, jk = map(jnp.asarray, (q, w, k))
    ref = np.asarray(jref7.reference(jq, jw, jk, heads=Hi, head_dim=Di))
    np.testing.assert_allclose(got, _pallas(q, w, k, Hi, Di), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)
    assert np.asarray(jk7.lightning_indexer(
        jq, jw, jk, heads=Hi, head_dim=Di, interpret=True)).shape == (2, S, T)


@pytest.mark.parametrize("Di,S,T", [(64, 37, 333), (128, 9, 200)])
def test_k7_tf32_arithmetic_8_heads(Di, S, T):
    q, w, k = _inputs(Di + S, 2, S, T, 8, Di)
    want = _pallas(q, w, k, 8, Di)
    args = [torch.from_numpy(x) for x in (q, w, k)]
    got = k7_tf32_arithmetic(*args, heads=8).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = k7_tf32_arithmetic(*args, heads=8, products=1).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("Di,S,T", [(64, 37, 333), (128, 9, 200)])
def test_k7_bf16_arithmetic_8_heads(Di, S, T):
    q, w, k = _inputs(Di + T, 2, S, T, 8, Di, bf16=True)
    want = _pallas(q, w, k, 8, Di)
    got = k7_bf16_arithmetic(*map(torch.from_numpy, (q, w, k)),
                             heads=8).numpy()
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound


def test_k7_route_by_shape():
    assert K7.body(8, 64) == K7.body(16, 64) == K7.body(32, 128) \
        == "indexer_mma"
    assert K7.body(2, 16) == K7.body(4, 32) == K7.body(64, 64) \
        == "indexer_tile"
