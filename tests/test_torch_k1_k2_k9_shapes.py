"""PyTorch port: K1 / K2 / K9 at the shapes of the rest of the model
registry, against the JAX package's Pallas kernels in interpret mode
(both take these shapes there).

* the plain K1 (``paged_decode_gqa_plain``) and K2
  (``paged_prefill_gqa_plain``) at head dim 96 with G 1 (phi-3-vision: 32
  heads of 96, MHA) and at d 128 with G 3 (minitron, 24 / 8), G 6
  (nemotron-4, 48 / 8) and G 16 (qwen3-moe, 64 / 4), blocks of 8 and 16,
  ragged rows (an idle slot, lengths inside and across blocks, spans
  starting mid-block), against the Pallas ``paged_decode_gqa`` /
  ``paged_prefill_gqa``, atol 1e-5;
* the plain K9 at d 96, causal and not, and at whisper's shapes (8 heads
  of 64, not causal, Sq != Sk: a text span and one decode row against
  the frames), against the Pallas ``flash_attention``, 2e-5; and
  ``flash_attend`` (K9's forward, the plain backward recomputed with the
  same mask a query chunk at a time) at those shapes, values and
  gradients against ``jax.value_and_grad`` of the reference's
  ``dense_attention``, rtol 1e-4;
* the 3xTF32 tile's arithmetic at d 96 (twelve n-tiles of 8, twelve
  k-steps of 8) against the Pallas kernel at 1e-5, one TF32 product shown
  to miss it; the bf16 tile's (six k-steps of 16) at the bf16 bound,
  parts 1 and 4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk9
from repro.kernels.paged_attention.kernel import paged_decode_gqa
from repro.kernels.paged_attention.prefill import paged_prefill_gqa
from repro.layers.attention import dense_attention as jax_dense_attention
from repro_torch.kernels.flash_attention import kernel as K9
from repro_torch.kernels.paged_attention import kernel as K1
from repro_torch.kernels.paged_attention import prefill as K2
from repro_torch.layers.attention import flash_attend
from test_torch_flash_bf16_numerics import bf16_tile_attention
from test_torch_tile_numerics import _bf16, _bh, tf32_tile_attention
from _torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5
B, MB = 5, 4
# (KVH, G, d): phi-3's MHA at d 96, the GQA groups of minitron / nemotron /
# qwen3 at d 128 (KV heads cut to keep the CPU cheap)
PAGED = [(4, 1, 96), (2, 3, 128), (2, 6, 128), (1, 16, 128)]


def _paged_inputs(seed, KVH, G, d, bs, S=None):
    """Pools with a trash block at the end, disjoint shuffled tables (row 0
    of a decode batch is an idle slot: all trash, length 0)."""
    rng = np.random.default_rng(seed)
    nb = B * MB + 1
    kp = rng.standard_normal((nb, bs, KVH, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, KVH, d)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    if S is None:
        tables[0] = nb - 1
        pos = np.asarray([0, 1, bs - 1, bs, MB * bs - 1], np.int32)
        q = rng.standard_normal((B, KVH, G, d)).astype(np.float32)
    else:
        pos = np.asarray([0, bs - 1, bs + 3, 2, MB * bs - S], np.int32)
        q = rng.standard_normal((B, KVH, S * G, d)).astype(np.float32)
    return q, kp, vp, tables, pos


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("KVH,G,d", PAGED)
def test_plain_k1_matches_pallas(KVH, G, d, bs):
    q, kp, vp, tables, lens = _paged_inputs(G + d, KVH, G, d, bs)
    want = np.asarray(paged_decode_gqa(*map(jnp.asarray,
                                            (q, kp, vp, tables, lens)),
                                       interpret=True))
    got = K1.paged_decode_gqa_plain(*map(torch.from_numpy,
                                         (q, kp, vp, tables, lens)))
    assert got.shape == (B, KVH, G, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("KVH,G,d", PAGED)
def test_plain_k2_matches_pallas(KVH, G, d, bs):
    S = 5      # packed rows S*G: 5, 15, 30 and 80, none a whole 64-row tile
    q, kp, vp, tables, starts = _paged_inputs(G + d + 1, KVH, G, d, bs, S=S)
    want = np.asarray(paged_prefill_gqa(
        *map(jnp.asarray, (q, kp, vp, tables, starts)), groups=G,
        interpret=True))
    got = K2.paged_prefill_gqa_plain(
        *map(torch.from_numpy, (q, kp, vp, tables, starts)), groups=G)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


# (H, KVH, Sq, Sk, d, kwargs): phi-3 at d 96 (heads cut to 4), causal and
# not; whisper's cross-attention (8 heads of 64, a text span and a decode
# row against frames) and its encoder (not causal, Sq = Sk)
K9_CASES = [
    (4, 4, 70, 70, 96, dict(causal=True)),
    (4, 4, 50, 90, 96, dict(causal=False)),
    (8, 8, 48, 150, 64, dict(causal=False)),
    (8, 8, 1, 150, 64, dict(causal=False)),
    (8, 8, 150, 150, 64, dict(causal=False)),
]


def _qkv(seed, Sq, Sk, H, KVH, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, Sq, H, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KVH, d)).astype(np.float32),
            rng.standard_normal((1, Sk, KVH, d)).astype(np.float32))


def _pallas_k9(q, k, v, G, kw):
    return np.asarray(jk9.flash_attention(
        jnp.asarray(_bh(q)), jnp.asarray(_bh(k, G)), jnp.asarray(_bh(v, G)),
        interpret=True, **kw))


@pytest.mark.parametrize("case", range(len(K9_CASES)))
def test_plain_k9_matches_pallas(case):
    H, KVH, Sq, Sk, d, kw = K9_CASES[case]
    q, k, v = _qkv(case, Sq, Sk, H, KVH, d)
    assert d in K9.HEAD_DIMS
    got = _bh(K9.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 **kw).numpy())
    np.testing.assert_allclose(got, _pallas_k9(q, k, v, H // KVH, kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", range(len(K9_CASES)))
def test_flash_attend_grads_match_jax(case):
    H, KVH, Sq, Sk, d, kw = K9_CASES[case]
    q, k, v = _qkv(40 + case, Sq, Sk, H, KVH, d)
    g = np.random.default_rng(41 + case).standard_normal(q.shape) \
        .astype(np.float32)
    qpos = jnp.broadcast_to(jnp.arange(Sq), (1, Sq))
    kpos = jnp.broadcast_to(jnp.arange(Sk), (1, Sk))

    def jfn(q, k, v):
        out = jax_dense_attention(q, k, v, qpos, kpos, causal=kw["causal"])
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attend(tq, tk, tv, causal=kw["causal"], q_chunk=32)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("case", [0, 1])
def test_tf32_tile_d96_matches_pallas(case):
    H, KVH, Sq, Sk, d, kw = K9_CASES[case]
    q, k, v = _qkv(10 + case, Sq, Sk, H, KVH, d)
    want = _pallas_k9(q, k, v, H // KVH, kw)
    G = H // KVH
    args = [torch.from_numpy(x) for x in (_bh(q), _bh(k, G), _bh(v, G))]
    got = tf32_tile_attention(*args, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = tf32_tile_attention(*args, products=1, **kw).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("parts", [1, 4])
@pytest.mark.parametrize("case", [0, 1])
def test_bf16_tile_d96_matches_pallas(case, parts):
    H, KVH, Sq, Sk, d, kw = K9_CASES[case]
    q, k, v = (_bf16(torch.from_numpy(x)).numpy()
               for x in _qkv(20 + case, Sq, Sk, H, KVH, d))
    want = _pallas_k9(q, k, v, H // KVH, kw)
    got = _bh(bf16_tile_attention(*map(torch.from_numpy, (q, k, v)),
                                  parts=parts, **kw).numpy())
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    assert 0.0 < float(np.abs(got - want).max()) <= bound
