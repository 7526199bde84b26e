"""PyTorch port, kernels K1/K2: plain versions vs the JAX Pallas kernels.

The port's plain PyTorch K1 (``paged_decode_gqa_plain``) and K2
(``paged_prefill_gqa_plain``) — what the kernel wrappers run on CPU
tensors — are held against the reference's Pallas kernels in interpret
mode and against both packages' gather oracles, on the same numpy-seeded
inputs in fp32: ragged lengths (0 = trash row, 1, bs-1, bs, deep), shuffled
tables, spans starting mid-block, window and softcap.  Tolerance atol 1e-5
(fp32, different summation order).  The ``cuda`` case holds the CUDA
kernels against the plain versions on the card; the JAX package is
imported only by the cases that need it, so this file also runs where JAX
is not installed (the GPU machine:
``PYTHONPATH=src python -m pytest --noconftest -m cuda
tests/test_torch_paged_attention.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as K1
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import prefill as K2
from repro_torch.kernels.paged_attention import ref as tref

ATOL = 1e-5
B, KVH, G, D, BS, MB = 5, 2, 2, 32, 8, 4
CASES = [(0, 0.0), (0, 30.0), (5, 0.0), (6, 20.0)]     # (window, softcap)


def _inputs(seed, S=None, d=D):
    """Pools with a trash block at the end, disjoint shuffled tables (row 0
    of a decode batch is an idle slot: all trash, length 0)."""
    rng = np.random.default_rng(seed)
    nb = B * MB + 1
    kp = rng.standard_normal((nb, BS, KVH, d)).astype(np.float32)
    vp = rng.standard_normal((nb, BS, KVH, d)).astype(np.float32)
    tables = rng.permutation(nb - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    if S is None:
        tables[0] = nb - 1
        pos = np.asarray([0, 1, BS - 1, BS, MB * BS - 1], np.int32)
        q = rng.standard_normal((B, KVH, G, d)).astype(np.float32)
    else:
        pos = np.asarray([0, BS - 1, BS + 3, 2, MB * BS - S], np.int32)
        q = rng.standard_normal((B, KVH, S * G, d)).astype(np.float32)
    return q, kp, vp, tables, pos


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _reference():
    """The JAX package's Pallas kernels and gather oracles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.paged_attention import ref
    from repro.kernels.paged_attention.kernel import paged_decode_gqa
    from repro.kernels.paged_attention.prefill import paged_prefill_gqa
    return jnp, ref, paged_decode_gqa, paged_prefill_gqa


@pytest.mark.parametrize("window,softcap", CASES)
def test_plain_decode_matches_pallas_and_gather(window, softcap):
    jnp, jref, jax_decode, _ = _reference()
    q, kp, vp, tables, lens = _inputs(0)
    want = np.asarray(jax_decode(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(tables),
                                 jnp.asarray(lens), window=window,
                                 softcap=softcap, interpret=True))
    got = K1.paged_decode_gqa_plain(*_t(q, kp, vp, tables, lens),
                                    window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert np.isfinite(got.numpy()[0]).all()          # the trash row
    # the gather oracles of both packages, in the model layout (B,1,H,d)
    qm = q.reshape(B, 1, KVH * G, D)
    want_ref = np.asarray(jref.paged_gqa_reference(
        jnp.asarray(qm), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), window=window,
        softcap=softcap))
    got_ref = tref.paged_gqa_reference(*_t(qm, kp, vp, tables, lens),
                                       window=window, softcap=softcap)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL, rtol=0)
    # dispatch on CPU tensors: impl="kernel" runs the plain version
    got_ops = ops.paged_gqa_attend(*_t(qm, kp, vp, tables, lens),
                                   window=window, softcap=softcap)
    np.testing.assert_allclose(got_ops.numpy()[1:], want_ref[1:], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("window,softcap", CASES)
def test_plain_prefill_matches_pallas_and_gather(window, softcap):
    jnp, jref, _, jax_prefill = _reference()
    S = 5
    q, kp, vp, tables, starts = _inputs(1, S=S)
    want = np.asarray(jax_prefill(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(starts), groups=G,
                                  window=window, softcap=softcap,
                                  interpret=True))
    got = K2.paged_prefill_gqa_plain(*_t(q, kp, vp, tables, starts),
                                     groups=G, window=window,
                                     softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # model layout (B, S, H, d): packed row i*G + g is head kvh*G + g
    qm = q.reshape(B, KVH, S, G, D).transpose(0, 2, 1, 3, 4) \
        .reshape(B, S, KVH * G, D)
    want_ref = np.asarray(jref.paged_gqa_prefill_reference(
        jnp.asarray(qm), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(starts), window=window,
        softcap=softcap))
    got_ref = tref.paged_gqa_prefill_reference(
        *_t(qm, kp, vp, tables, starts), window=window, softcap=softcap)
    np.testing.assert_allclose(got_ref.numpy(), want_ref, atol=ATOL, rtol=0)
    got_ops = ops.paged_gqa_prefill(*_t(qm, kp, vp, tables, starts),
                                    window=window, softcap=softcap)
    np.testing.assert_allclose(got_ops.numpy(), want_ref, atol=ATOL, rtol=0)


def test_dispatch_rejects_unknown_impl():
    q, kp, vp, tables, lens = _inputs(2)
    qm = torch.from_numpy(q.reshape(B, 1, KVH * G, D))
    with pytest.raises(ValueError):
        ops.paged_gqa_attend(qm, *_t(kp, vp, tables, lens), impl="blocked")


def test_kernel_argument_check_refuses_cpu_and_bad_shapes():
    q, kp, vp, tables, lens = _t(*_inputs(3))
    with pytest.raises(ValueError):                  # not a CUDA tensor
        K1.check_cuda_args(q, kp, vp, tables, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    # the kernels take head_dim 64/128/256 (the CPU cases use 32)
    for window, softcap in CASES:
        q, kp, vp, tables, lens = (torch.from_numpy(a).cuda() for a in
                                   _inputs(4, d=64))
        q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
        got = K1.paged_decode_gqa(q, kp, vp, tables, lens, window=window,
                                  softcap=softcap)
        want = K1.paged_decode_gqa_plain(q, kp, vp, tables, lens,
                                         window=window, softcap=softcap)
        assert (got.float() - want.float()).abs().max().item() <= tol
        q, kp, vp, tables, st = (torch.from_numpy(a).cuda() for a in
                                 _inputs(5, S=5, d=64))
        q, kp, vp = (x.to(dtype) for x in (q, kp, vp))
        got = K2.paged_prefill_gqa(q, kp, vp, tables, st, groups=G,
                                   window=window, softcap=softcap)
        want = K2.paged_prefill_gqa_plain(q, kp, vp, tables, st, groups=G,
                                          window=window, softcap=softcap)
        assert (got.float() - want.float()).abs().max().item() <= tol
