"""PyTorch port, K10 chunked cross-entropy and ``models.losses``, against the
JAX package (the CUDA kernel's own cases are in
``test_torch_kernels_cuda.py``).

Numpy-seeded inputs go through both packages in fp32:

* the plain K10 (``kernels.chunked_ce.ref.reference``, what the wrapper
  runs on CPU tensors) against the Pallas kernel in interpret mode and
  against its ``ref.reference`` (the model's ``chunked_softmax_xent``):
  V not a multiple of the kernel's vocab block, softcap 0 and 30, a
  partial mask; Tk not a multiple of the token block against ``ref`` only
  (the Pallas kernel leaves a ragged token block's padding rows unmasked,
  which interpret mode fills with NaN); the two sums within rtol 1e-5
  (they add ~300 NLLs in another order);
* ``chunked_softmax_xent`` (the autograd Function: K10 forward, a plain
  chunked backward) and ``mean_xent``: value and the gradients of h and the
  unembedding against ``jax.grad`` of the reference's, for a chunk that
  divides S, one that does not and none; rtol 1e-4, atol 1e-6;
* ``token_logprobs`` against the reference's;
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.chunked_ce import kernel as jk10
from repro.kernels.chunked_ce import ref as jref10
from repro.models import losses as jlosses
from repro_torch.kernels.chunked_ce import kernel as K10
from repro_torch.kernels.chunked_ce import ops
from repro_torch.models import losses


def _inputs(seed, Tk, D, V, masked=0.3):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((Tk, D), np.float32)
    w = (rng.standard_normal((D, V)) * D ** -0.5).astype(np.float32)
    t = rng.integers(0, V, Tk).astype(np.int32)
    m = (rng.random(Tk) > masked).astype(np.float32)
    return h, w, t, m


@pytest.mark.parametrize("Tk,V,softcap", [(256, 700, 0.0), (64, 520, 30.0),
                                          (300, 700, 30.0)])
def test_plain_matches_pallas_and_reference(Tk, V, softcap):
    h, w, t, m = _inputs(0, Tk, 64, V)
    loss, count = K10.chunked_ce(*map(torch.from_numpy, (h, w, t, m)),
                                 softcap=softcap)
    jh, jw, jt, jm = map(jnp.asarray, (h, w, t, m))
    wants = [jref10.reference(jh, jw, jt, jm, softcap=softcap)]
    if Tk <= 128 or Tk % 128 == 0:
        wants.append(jk10.chunked_ce(jh, jw, jt, jm, softcap=softcap,
                                     interpret=True))
    for want_l, want_c in wants:
        np.testing.assert_allclose(float(loss), float(want_l), rtol=1e-5)
        assert float(count) == float(want_c) == float(m.sum())
    # the (B, S) entry point flattens to the same call
    b_loss, b_count = ops.xent_loss(
        torch.from_numpy(h)[None], torch.from_numpy(w), torch.from_numpy(t)[None],
        torch.from_numpy(m)[None], softcap=softcap)
    assert float(b_loss) == float(loss) and float(b_count) == float(count)


@pytest.mark.parametrize("chunk,softcap", [(32, 0.0), (48, 30.0), (0, 0.0)])
def test_chunked_softmax_xent_grads_match_jax(chunk, softcap):
    B, S, D, V = 2, 96, 48, 300
    h, w, t, m = _inputs(1, B * S, D, V)
    h, t, m = h.reshape(B, S, D), t.reshape(B, S), m.reshape(B, S)

    def jfn(h, w):
        return jlosses.mean_xent(h, w, jnp.asarray(t), jnp.asarray(m),
                                 chunk=chunk, softcap=softcap)

    jval, (jgh, jgw) = jax.value_and_grad(jfn, argnums=(0, 1))(h, w)
    th, tw = (torch.from_numpy(x).requires_grad_() for x in (h, w))
    val = losses.mean_xent(th, tw, torch.from_numpy(t), torch.from_numpy(m),
                           chunk=chunk, softcap=softcap)
    val.backward()
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(jgh), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jgw), rtol=1e-4,
                               atol=1e-6)
    s, c = losses.chunked_softmax_xent(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(t),
        torch.from_numpy(m), chunk=chunk, softcap=softcap)
    js, jc = jlosses.chunked_softmax_xent(h, w, t, m, chunk=chunk,
                                          softcap=softcap)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)
    assert float(c) == float(jc)


def test_token_logprobs_match_jax():
    rng = np.random.default_rng(2)
    lg = rng.standard_normal((2, 7, 50)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7))
    np.testing.assert_allclose(
        losses.token_logprobs(torch.from_numpy(lg), torch.from_numpy(tok)),
        np.asarray(jlosses.token_logprobs(lg, tok)), rtol=1e-6, atol=1e-6)


def test_cuda_args_are_checked():
    h, w, t, m = map(torch.from_numpy, _inputs(3, 8, 16, 32))
    with pytest.raises(ValueError):
        K10.check_cuda_args(h, w, t, m)        # CPU tensors

