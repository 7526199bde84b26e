"""PyTorch port: the arithmetic of K11's scan (``csrc/mamba_scan.cu``),
written out in plain PyTorch on the CPU and held against the JAX package's
Pallas ``mamba_scan`` in interpret mode and the port's ``ref.scan_model``.
The CUDA kernel itself runs only on the card
(``test_torch_kernels_cuda.py``, ``chip_smoke.py``); this file shows that
its numerics, not only its code, stay within the port's bounds.

The kernel's arithmetic, in fp32: A2 = A * log2(e) formed once a channel;
a step's dA = exp2(dt * A2) and dBx = (dt * x) * B, h = dA * h + dBx by a
fused multiply-add, y = the states' fused multiply-adds with C in order.
Time is cut into ``parts`` chunks of ceil(S / parts) steps: pass 1 runs
every chunk but the last from h = 0 and keeps its end state and its decay
exp2(A2 * sum dt); pass 2 starts chunk c from h0 folded through chunks
0 .. c-1 (h = decay * h + h_end) and reruns it, writing y and, in the last
chunk, hT.  parts 1 is the plain walk.

Tolerances: against the reference (fp32, dA = exp(dt * A) a step, its own
order of sums), 1e-5 relative to max(1, max|reference|).  The exponential
by exp2 of a rounded A2, and a chunk's decay as one exponential of the
summed dt where the walk multiplies one exponential a step, each differ by
a few fp32 ulps a step (~1e-7 relative): over the ~100 steps here, well
under 1e-5, and far under the 1e-4 the card's kernel is held to.  Inputs
with slow decay (dt ~0.01-0.06, |A| ~1) carry the state across many chunks,
so a wrong carry shows; fast decay is the model's usual regime.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.kernel import mamba_scan as jax_mamba_scan
from repro_torch.kernels.mamba_scan import kernel, ref

LOG2E = 1.4426950408889634


def _fma(a, b, c):
    """fp32 fused multiply-add: a*b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _walk(dt, A2, dx, Bc, Cc, h, t0, t1, ys=None):
    """Steps t0 .. t1 - 1 from h (B, E, N): returns (h, sum of dt), ys
    (B, S, E) written where given."""
    dsum = torch.zeros_like(dt[:, 0])
    for t in range(t0, t1):
        da = torch.exp2(dt[:, t, :, None] * A2)
        dbx = dx[:, t, :, None] * Bc[:, t, None, :]
        h = _fma(da, h, dbx)
        if ys is not None:
            y = torch.zeros_like(dt[:, 0])
            for n in range(h.shape[-1]):
                y = _fma(h[..., n], Cc[:, t, None, n], y)
            ys[:, t] = y
        dsum = dsum + dt[:, t]
    return h, dsum


def chunked_scan(dt, A, x, Bc, Cc, h0, parts):
    """K11's model form as the kernel computes it: dt, x (B, S, E), A
    (E, N), Bc, Cc (B, S, N), h0 (B, E, N), fp32 -> (y, hT)."""
    B, S, E = dt.shape
    A2 = A * torch.tensor(LOG2E, dtype=torch.float32)
    dx = dt * x
    L = math.ceil(S / parts)
    ends = []
    for c in range(parts - 1):                     # pass 1
        h, dsum = _walk(dt, A2, dx, Bc, Cc, torch.zeros_like(h0), c * L,
                        min(S, (c + 1) * L))
        ends.append((h, torch.exp2(A2 * dsum[..., None])))
    ys = torch.empty(B, S, E)
    for c in range(parts):                         # pass 2
        h = h0
        for h_end, decay in ends[:c]:
            h = _fma(decay, h, h_end)
        h, _ = _walk(dt, A2, dx, Bc, Cc, h, c * L, min(S, (c + 1) * L), ys)
    return ys, h


def _inputs(seed, B, S, E, N, slow):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, E)) - 1.0))
    A = -np.arange(1, N + 1)[None] * (1 + 0.1 * np.abs(
        rng.standard_normal((E, N))))
    if slow:
        dt, A = dt * 0.05, A / np.arange(1, N + 1)[None]
    x = rng.standard_normal((B, S, E))
    Bc, Cc = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, E, N)) * 0.5
    return [torch.from_numpy(a.astype(np.float32))
            for a in (dt, A, x, Bc, Cc, h0)]


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bound, f"max abs err {err} > {bound}"


@pytest.mark.parametrize("parts", [1, 2, 3, 7])
@pytest.mark.parametrize("B,S,E,N,slow", [(2, 50, 10, 4, True),
                                          (1, 97, 37, 16, True),
                                          (2, 23, 9, 8, False)])
def test_chunked_scan_matches_pallas_and_reference(parts, B, S, E, N, slow):
    ins = _inputs(S + E + N, B, S, E, N, slow)
    y, hT = chunked_scan(*ins, parts)
    assert y.shape == (B, S, E) and hT.shape == (B, E, N)
    # the reference's discretization (exp, a step at a time), its scan
    dt, A, x, Bc, Cc, h0 = ins
    dA, dBx = ref.discretize(dt, A, x, Bc)
    y_j, hT_j = jax_mamba_scan(*(jnp.asarray(t.numpy())
                                 for t in (dA, dBx, Cc, h0)), interpret=True)
    _close(y, y_j)
    _close(hT, hT_j)
    y_r, hT_r = ref.scan_model(*ins)
    _close(y, y_r)
    _close(hT, hT_r)


def test_chunk_carry_is_what_the_slow_inputs_test():
    """With slow decay, a chunk rerun from h = 0 misses the carry by far
    more than the bound: the test above would see a wrong fold."""
    ins = _inputs(5, 2, 50, 10, 4, slow=True)
    y_r, _ = ref.scan_model(*ins)
    dt, A, x, Bc, Cc, h0 = ins
    y0, _ = ref.scan_model(dt[:, 25:], A, x[:, 25:], Bc[:, 25:], Cc[:, 25:],
                           torch.zeros_like(h0))
    assert (y0 - y_r[:, 25:]).abs().max().item() > 1e-2


@pytest.mark.parametrize("ctas,S,want", [
    (512, 1024, 1),     # falcon-mamba's serve prefill, B 8: the card full
    (256, 2048, 1),     # B 4: two CTAs an SM already
    (128, 2048, 5),     # B 2 (training): one CTA an SM -> the 5 slots
    (64, 2048, 10),     # B 1
    (1, 2048, 16),      # at most MAX_PARTS
    (128, 200, 3),      # at most S // MIN_CHUNK
    (128, 50, 1),       # a short S stays whole
])
def test_parts_rule(ctas, S, want):
    """K11's time split from the shapes alone, on 132 SMs of 5 CTAs each:
    chunks only where one pass leaves an SM at most one CTA."""
    assert kernel.parts_rule(ctas, S, 132, 5) == want
