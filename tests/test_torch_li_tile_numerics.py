"""PyTorch port: the arithmetic of K7's two tensor-core routes (the indexer
body of ``csrc/indexer_mma.cuh`` over contiguous keys), written out in
plain PyTorch on the CPU and held against the JAX package's Pallas
``lightning_indexer`` in interpret mode.  The CUDA body itself runs only on
the card (``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this file
shows that its numerics, not only its code, stay within the port's bounds.

* fp32 by 3xTF32: each fp32 operand is big + small, both rounded as
  ``cvt.rna.tf32.f32`` rounds; each k-step of 8 dims adds three products
  to the fp32 accumulator, small keys x big queries, big keys x small
  queries, then big x big (each product of TF32 values exact in fp32, the
  8 of a step summed in fp32); the epilogue as the bf16 route's.  Held at
  1e-5 (atol and rtol): the bound of the other 3xTF32 tiles, and the
  trainer's parity is fp32 with TF32 off; one TF32 product is shown to
  miss it.
* bf16 on mma.sync: bf16 values, exact bf16 x bf16 products summed in fp32
  16 dims a k-step; the epilogue takes the accumulator as a quad's four
  threads hold it (thread t: heads n*8 + 2t and + 1 of each n-tile),
  sums w * (ReLU(dot) * scale) over them by fused multiply-adds, then two
  xor shuffles add the four threads' sums ((t0 + t1) + (t2 + t3)).  Held
  at the bf16 bound, 2e-2 scaled by min(1, max|reference|).

Both at Hi 16 / Di 64 (Yi-6B's indexer) and Hi 32 / Di 128 (GLM-5's), S
and T ragged against the body's tokens a CTA and keys a round; every
(s, t) is finite: K7 has no dead key and writes no NEG_INF.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lightning_indexer.kernel import \
    lightning_indexer as jax_lightning_indexer
from test_torch_tile_numerics import split_tf32


def _fma(a, b, c):
    """fp32 fused multiply-add: a*b + c rounded once (the product of two
    fp32 values is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def _epilogue(dot, w, scale):
    """The accumulator's epilogue: dot (S, Hi, T) fp32, w (S, Hi) -> (S, T):
    ReLU and scale, each quad thread's heads summed by fmas in order, then
    (t0 + t1) + (t2 + t3)."""
    S, Hi, T = dot.shape
    v = torch.relu(dot) * scale
    quad = []
    for t in range(4):
        s = torch.zeros(S, T)
        for n in range(Hi // 8):
            for u in range(2):
                h = n * 8 + 2 * t + u
                s = _fma(w[:, h, None].expand(S, T), v[:, h], s)
        quad.append(s)
    return (quad[0] + quad[1]) + (quad[2] + quad[3])


def k7_tf32_arithmetic(q_idx, w_head, k_idx, *, heads, products=3):
    """K7's fp32 route: q_idx (B, S, Hi*Di), w_head (B, S, Hi), k_idx
    (B, T, Di) fp32 -> (B, S, T); ``products=1`` the single TF32 product."""
    B, S, _ = q_idx.shape
    T, Di = k_idx.shape[1:]
    scale = torch.tensor(Di ** -0.5, dtype=torch.float32)
    out = torch.empty(B, S, T)
    for b in range(B):
        qb, qs = split_tf32(q_idx[b].reshape(S, heads, Di))
        kb, ks = split_tf32(k_idx[b])
        dot = torch.zeros(S, heads, T)
        for kk in range(0, Di, 8):          # one m16n8k8 k-step a product
            d = slice(kk, kk + 8)
            terms = [(kb, qb)] if products == 1 else \
                [(ks, qb), (kb, qs), (kb, qb)]
            for kx, qx in terms:
                dot = dot + torch.einsum("shd,td->sht", qx[..., d], kx[:, d])
        out[b] = _epilogue(dot, w_head[b], scale)
    return out


def k7_bf16_arithmetic(q_idx, w_head, k_idx, *, heads):
    """K7's bf16 route: q_idx and k_idx bf16 values (as fp32) ->
    (B, S, T)."""
    B, S, _ = q_idx.shape
    T, Di = k_idx.shape[1:]
    scale = torch.tensor(Di ** -0.5, dtype=torch.float32)
    out = torch.empty(B, S, T)
    for b in range(B):
        q = q_idx[b].reshape(S, heads, Di)
        dot = torch.zeros(S, heads, T)
        for ks in range(0, Di, 16):         # one m16n8k16 k-step a product
            dot = dot + torch.einsum("shd,td->sht", q[..., ks:ks + 16],
                                     k_idx[b][:, ks:ks + 16])
        out[b] = _epilogue(dot, w_head[b], scale)
    return out


def _inputs(seed, B, S, T, Hi, Di, bf16=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hi * Di)).astype(np.float32)
    k = rng.standard_normal((B, T, Di)).astype(np.float32)
    if bf16:
        q, k = (torch.from_numpy(x).bfloat16().float().numpy()
                for x in (q, k))
    w = rng.standard_normal((B, S, Hi)).astype(np.float32)
    w = np.exp(w) / np.exp(w).sum(-1, keepdims=True)
    return q, w.astype(np.float32), k


def _pallas(q, w, k, Hi, Di):
    return np.asarray(jax_lightning_indexer(
        jnp.asarray(q), jnp.asarray(w), jnp.asarray(k), heads=Hi,
        head_dim=Di, interpret=True))


@pytest.mark.parametrize("Hi,Di,S,T", [(16, 64, 37, 333),
                                       (32, 128, 9, 200)])
def test_k7_tf32_arithmetic_matches_pallas(Hi, Di, S, T):
    q, w, k = _inputs(Hi + S, 2, S, T, Hi, Di)
    want = _pallas(q, w, k, Hi, Di)
    args = [torch.from_numpy(x) for x in (q, w, k)]
    got = k7_tf32_arithmetic(*args, heads=Hi).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    one = k7_tf32_arithmetic(*args, heads=Hi, products=1).numpy()
    assert np.abs(one - want).max() > 1e-5 + 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("Hi,Di,S,T", [(16, 64, 37, 333),
                                       (32, 128, 9, 200)])
def test_k7_bf16_arithmetic_matches_pallas(Hi, Di, S, T):
    q, w, k = _inputs(Hi + T, 2, S, T, Hi, Di, bf16=True)
    want = _pallas(q, w, k, Hi, Di)
    got = k7_bf16_arithmetic(*map(torch.from_numpy, (q, w, k)),
                             heads=Hi).numpy()
    assert np.isfinite(got).all()
    bound = 2e-2 * min(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= bound

