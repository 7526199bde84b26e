"""PyTorch port, K9 flash attention: the plain version and the autograd
Function, against the JAX package (the CUDA kernel's own cases are in
``test_torch_kernels_cuda.py``).

Numpy-seeded inputs go through both packages in fp32:

* the plain K9 (``kernels.flash_attention.ref.reference``, what the
  wrapper runs on CPU tensors) against the Pallas kernel in interpret mode
  (the reference's (BH, S, d) layout, KV heads repeated as its
  ``ops.attend`` does) and against its ``ref.reference``: causal and not,
  a sliding window, a logit softcap, ``q_offset`` with Sq < Sk, S not a
  multiple of the 128 block; atol/rtol 2e-5 (summation order);
* ``flash_attend``'s output and its gradients of q, k and v against
  ``jax.grad`` of the reference's ``dense_attention`` (query-chunked as the
  model runs it), with window and softcap; rtol 1e-4, atol 1e-5;
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import kernel as jk9
from repro.kernels.flash_attention import ref as jref9
from repro.layers.attention import dense_attention as jax_dense_attention
from repro_torch.kernels.flash_attention import kernel as K9
from repro_torch.kernels.flash_attention import ops
from repro_torch.layers.attention import flash_attend

ATOL = RTOL = 2e-5


def _qkv(seed, B, Sq, Sk, H, KVH, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, d), np.float32),
            rng.standard_normal((B, Sk, KVH, d), np.float32),
            rng.standard_normal((B, Sk, KVH, d), np.float32))


def _to_bh(x, G=1):
    """(B, S, heads, d) -> the reference kernel's (B*heads*G, S, d)."""
    if G > 1:
        x = np.repeat(x, G, axis=2)
    B, S, H, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, d)


@pytest.mark.parametrize("Sq,Sk,kw", [
    (200, 200, dict(causal=True)),
    (130, 130, dict(causal=True, window=48, softcap=30.0)),
    (96, 160, dict(causal=True, q_offset=64)),
    (70, 150, dict(causal=False, softcap=20.0)),
])
def test_plain_matches_pallas_and_reference(Sq, Sk, kw):
    B, H, KVH, d = 2, 4, 2, 64
    q, k, v = _qkv(0, B, Sq, Sk, H, KVH, d)
    got = K9.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    qb, kb, vb = _to_bh(q), _to_bh(k, H // KVH), _to_bh(v, H // KVH)
    pallas = np.asarray(jk9.flash_attention(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb), interpret=True,
        **kw))
    ref = np.asarray(jref9.reference(jnp.asarray(qb), jnp.asarray(kb),
                                     jnp.asarray(vb), **kw))
    mine = _to_bh(got)
    np.testing.assert_allclose(mine, pallas, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(mine, ref, atol=ATOL, rtol=RTOL)
    if "q_offset" not in kw:     # the model-layout entry point: the same
        np.testing.assert_array_equal(
            ops.attend(*map(torch.from_numpy, (q, k, v)), **kw).numpy(), got)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (40, 50.0)])
def test_flash_attend_grads_match_jax(window, softcap):
    B, S, H, KVH, d = 2, 160, 4, 2, 32
    q, k, v = _qkv(1, B, S, S, H, KVH, d)
    g = np.random.default_rng(2).standard_normal((B, S, H, d), np.float32)
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))

    def jfn(q, k, v):
        out = jax_dense_attention(q, k, v, pos, pos, causal=True,
                                  window=window, softcap=softcap, q_chunk=32)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attend(tq, tk, tv, window=window, softcap=softcap, q_chunk=64)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-4, atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-5)


def test_cuda_args_are_checked():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 8, 8, 2, 1, 48))
    with pytest.raises(ValueError):
        K9.check_cuda_args(q, k, v)          # CPU tensors
    # the CPU wrapper still runs any head dim through the plain version
    assert K9.flash_attention(q, k, v).shape == q.shape

