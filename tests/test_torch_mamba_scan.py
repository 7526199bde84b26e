"""PyTorch port, K11 (the Mamba-1 selective scan) against the JAX package.

* The contract form (``ops.selective_scan``, impl ``kernel`` on CPU
  tensors = its plain version, and impl ``ref``) against the reference's
  ``selective_scan`` run as its own test runs it (the Pallas kernel in
  interpret mode, ``tests/test_kernels.py``), at that test's three shapes
  and one whose S is not a multiple of ``seq_chunk``; atol/rtol 1e-4.
* The model form (``kernel.mamba_scan_model``) against the contract form
  fed with the same discretization (equal: the same fp32 operations), and
  against the reference's ``_mamba1_scan`` after the reference's own
  discretization (``layers/ssm.apply_mamba1``), with fp32 and bf16 inputs;
  a bf16 h0 is read as it is.
* The autograd Function (``kernel.mamba1_scan``): its plain chunked
  backward against ``torch.autograd`` through the plain forward, with S
  inside one ``ref.BWD_CHUNK``, a multiple of it and a ragged S past two
  chunks, and against ``jax.grad`` of the
  reference's discretization followed by ``_mamba1_scan``; every gradient
  within 1e-5 of its max |gradient| (fp32, sums in another order).

Inputs are numpy-seeded and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.ops import selective_scan as jax_selective_scan
from repro.layers.ssm import _mamba1_scan
from repro_torch.kernels.mamba_scan import kernel, ops, ref


def _contract_inputs(B, S, E, N, seed):
    rng = np.random.default_rng(seed)
    dA = 1 / (1 + np.exp(-rng.standard_normal((B, S, E, N))))
    dBx = rng.standard_normal((B, S, E, N)) * 0.1
    C = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, E, N)) * 0.1
    return [a.astype(np.float32) for a in (dA, dBx, C, h0)]


def _model_inputs(B, S, E, N, seed):
    """dt > 0 as softplus gives it, A = -exp(A_log) with the reference's
    log(1..N) init jittered, x / Bc / Cc / h0 unit normal."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, E)) - 1.0))
    A = -np.arange(1, N + 1)[None] * (1 + 0.1 * np.abs(
        rng.standard_normal((E, N))))
    x = rng.standard_normal((B, S, E))
    Bc, Cc = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, E, N)) * 0.5
    return [a.astype(np.float32) for a in (dt, A, x, Bc, Cc, h0)]


def _jax_model_scan(dt, A, x, Bc, Cc, h0):
    """The reference's discretization (``apply_mamba1``) and scan."""
    dtf = dt.astype(jnp.float32)
    dA = jnp.exp(dtf[..., None] * A[None, None])
    dBx = (dtf * x.astype(jnp.float32))[..., None] \
        * Bc.astype(jnp.float32)[..., None, :]
    return _mamba1_scan(dA, dBx, Cc.astype(jnp.float32),
                        h0.astype(jnp.float32))


@pytest.mark.parametrize("B,S,E,N,chunk", [
    (2, 128, 64, 8, 64), (1, 96, 32, 16, 96), (1, 64, 128, 4, 16),
    (2, 100, 48, 8, 32),
])
def test_contract_matches_pallas_interpret(B, S, E, N, chunk):
    ins = _contract_inputs(B, S, E, N, seed=S + E)
    y_j, hT_j = jax_selective_scan(*map(jnp.asarray, ins), seq_chunk=chunk)
    t_ins = [torch.from_numpy(a) for a in ins]
    for impl in ("kernel", "ref"):
        y, hT = ops.selective_scan(*t_ins, seq_chunk=chunk, impl=impl)
        assert y.dtype == hT.dtype == torch.float32
        np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), atol=1e-4,
                                   rtol=1e-4)
    with pytest.raises(ValueError):
        ops.selective_scan(*t_ins, impl="pallas")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_form_matches_contract_and_reference(dtype):
    B, S, E, N = 2, 45, 24, 8
    ins = _model_inputs(B, S, E, N, seed=3)
    dt, A, x, Bc, Cc, h0 = (torch.from_numpy(a) for a in ins)
    dt, x, Bc, Cc = (t.to(dtype) for t in (dt, x, Bc, Cc))
    y, hT = kernel.mamba_scan_model(dt, A, x, Bc, Cc, h0)
    assert y.dtype == hT.dtype == torch.float32
    assert y.shape == (B, S, E) and hT.shape == (B, E, N)
    dA, dBx = ref.discretize(dt, A, x, Bc)
    y_c, hT_c = kernel.mamba_scan(dA, dBx, Cc.float(), h0)
    torch.testing.assert_close(y, y_c, rtol=0, atol=0)
    torch.testing.assert_close(hT, hT_c, rtol=0, atol=0)
    # the reference on the same (widened) values
    j_ins = [jnp.asarray(t.float().numpy()) for t in (dt, A, x, Bc, Cc, h0)]
    y_j, hT_j = _jax_model_scan(*j_ins)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(hT.numpy(), np.asarray(hT_j), atol=1e-4,
                               rtol=1e-4)
    # a bf16 state is read as it is (the layer's bf16 serving state)
    h0b = h0.to(torch.bfloat16)
    yb, hTb = kernel.mamba_scan_model(dt, A, x, Bc, Cc, h0b)
    yf, hTf = kernel.mamba_scan_model(dt, A, x, Bc, Cc, h0b.float())
    torch.testing.assert_close(yb, yf, rtol=0, atol=0)
    torch.testing.assert_close(hTb, hTf, rtol=0, atol=0)


def _close_grads(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-4,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"gradient {i}")


@pytest.mark.parametrize("S", [29, 2 * ref.BWD_CHUNK,
                               2 * ref.BWD_CHUNK + 22])
def test_backward_matches_autograd_and_jax_grad(S):
    B, E, N = 2, 16, 4
    ins = _model_inputs(B, S, E, N, seed=5)
    rng = np.random.default_rng(6)
    g_y = rng.standard_normal((B, S, E)).astype(np.float32)
    g_hT = rng.standard_normal((B, E, N)).astype(np.float32)

    def grads_of(fn):
        xs = [torch.from_numpy(a).requires_grad_() for a in ins]
        y, hT = fn(*xs)
        torch.autograd.backward((y, hT), (torch.from_numpy(g_y),
                                          torch.from_numpy(g_hT)))
        return [t.grad.numpy() for t in xs]

    got = grads_of(lambda *a: kernel.mamba1_scan(*a))
    _close_grads(got, grads_of(ref.scan_model))

    def jax_objective(*a):
        y, hT = _jax_model_scan(*a)
        return jnp.sum(y * g_y) + jnp.sum(hT * g_hT)

    want = jax.grad(jax_objective, argnums=tuple(range(6)))(
        *map(jnp.asarray, ins))
    _close_grads(got, want)
    # only hT used: the y cotangent the Function receives is zeros
    xs = [torch.from_numpy(a).requires_grad_() for a in ins]
    kernel.mamba1_scan(*xs)[1].sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in xs)


def test_cuda_argument_checks_refuse_cpu_tensors():
    dt, A, x, Bc, Cc, h0 = (torch.from_numpy(a)
                            for a in _model_inputs(1, 3, 8, 4, seed=0))
    with pytest.raises(ValueError):
        kernel.check_cuda_args_model(dt, A, x, Bc, Cc, h0)
    dA, dBx = ref.discretize(dt, A, x, Bc)
    with pytest.raises(ValueError):
        kernel.check_cuda_args(dA, dBx, Cc, h0)
