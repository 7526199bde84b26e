"""PyTorch port: the arithmetic of K11's head-shared route on the tensor
cores, the chunked scan of ``csrc/ssd_scan.cuh``, written out in plain
PyTorch on the CPU and held against the JAX package's Mamba-2 scan
(``repro.layers.ssm._mamba2_scan``, a ``lax.scan`` a step at a time).
The CUDA kernels run only on the card (``test_torch_kernels_cuda.py``,
``chip_smoke.py``); this file shows that their numerics, not only their
code, stay within the port's bounds.

The kernels' arithmetic, in fp32, chunks of L = 64 steps (a ragged last
chunk padded with dt = 0, x = Bc = Cc = 0): a = dt * (A * log2(e)); the
segment sums S[t][s] = sum_{s<r<=t} a[r], each column a running sum from
s down the rows in order; M = exp2(S) on and below the diagonal; G = Cc
Bc^T, one product of exact bf16 values with fp32 sums where Bc and Cc
are bf16, else by 3xTF32; the end states E_c = ((x * dt) * m)^T Bc with
m[s] = exp2(sum_{r>s} a[r]) (suffix sums) and the decays exp2(sum a);
the fold h = fma(decay, h, E_c) from h0; y = ((M * G) * dt[s]) x + (e *
Cc) h_start^T, e[t] = exp2(sum_{r<=t} a[r]); every product but the bf16
G by 3xTF32 (big.big + big.small + small.big of TF32 values,
``test_torch_tile_numerics``'s bitwise ``cvt.rna``).

Held against JAX at 1e-5 of each head's max |JAX| (y and hT) on H 4
heads of P 64 with N 64, A down to -80, a nonzero h0, S 1, 63, 64 and
200, x / Bc / Cc in fp32 and as bf16 values.  dt is selective, as a Mamba
layer's is: runs of large steps (the state mostly forgotten) and runs of
small ones (held), so that late in a chunk the sum of a is large while
the decays between neighbouring steps still matter.  Two negative
controls miss 1e-4 of the A = -80 head's max: the decays as differences
of the chunk's cumulative sums (the fp32 ulp of a sum of ~-6000 moves a
short-range decay by ~3e-4), and the products as one TF32 product each.
Beside them, the wrapper's route rule (``kernel.body``) and the heads a
chunk CTA takes (``kernel.chunk_heads_rule``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.ssm import _mamba2_scan
from repro_torch.kernels.mamba_scan import kernel
from test_torch_tile_numerics import matmul_3xtf32
from _torch_threads import one_torch_thread  # noqa: F401

L = 64
LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
A_HEADS = (-1.0, -8.0, -30.0, -80.0)


def _fma(a, b, c):
    """fp32 fused multiply-add: a*b + c rounded once."""
    return (a.double() * b.double() + c.double()).float()


def _seq_cumsum(a):
    """fp32 running sums along the last dim, one add a step in order
    (``torch.cumsum`` on the CPU sums in double)."""
    out = torch.empty_like(a)
    run = torch.zeros_like(a[..., 0])
    for t in range(a.shape[-1]):
        run = run + a[..., t]
        out[..., t] = run
    return out


def _suffix_after(a):
    """fp32 sums of the steps after each one, added from the last step
    back: [..., s] = sum_{r>s} a[r]."""
    after = _seq_cumsum(a[..., 1:].flip(-1)).flip(-1)
    return torch.cat([after, torch.zeros_like(a[..., :1])], -1)


def _segment_sums(a):
    """a (..., L) -> S (..., L, L): column s a running sum from s + 1 down
    the rows, in order; 0 on and above the diagonal (never read there)."""
    n = a.shape[-1]
    S = torch.zeros(*a.shape, n)
    run = torch.zeros_like(a)                   # one a column
    cols = torch.arange(n)
    for t in range(1, n):
        below = cols < t
        run = torch.where(below, run + a[..., t, None], run)
        S[..., t, :] = torch.where(below, run, torch.zeros_like(run))
    return S


def ssd_arithmetic(dt, A, x, Bc, Cc, h0, *, bf16, products=3,
                   decays="segments"):
    """The chunked route as the kernels compute it: dt (B, S, H), A (H,),
    x (B, S, H*P), Bc / Cc (B, S, N) (bf16 values where ``bf16``), h0
    (B, H, P, N), fp32 -> y (B, S, H, P), hT (B, H, P, N).  ``products=1``
    takes each TF32 product once; ``decays="cumsum"`` takes the decays as
    differences of the chunk's cumulative sums (the negative controls)."""
    B, S, H = dt.shape
    P, N = x.shape[-1] // H, Bc.shape[-1]
    nc = -(-S // L)
    pad = nc * L - S
    a = dt * (A * LOG2E)
    pad_t = torch.nn.functional.pad
    xr = pad_t(x.reshape(B, S, H, P), (0, 0, 0, 0, 0, pad))
    dtp, a = pad_t(dt, (0, 0, 0, pad)), pad_t(a, (0, 0, 0, pad))
    Bp, Cp = pad_t(Bc, (0, 0, 0, pad)), pad_t(Cc, (0, 0, 0, pad))
    ah = a.reshape(B, nc, L, H).permute(0, 1, 3, 2)          # (B, nc, H, L)
    dth = dtp.reshape(B, nc, L, H).permute(0, 1, 3, 2)
    xh = xr.reshape(B, nc, L, H, P).permute(0, 1, 3, 2, 4)   # (B, nc, H, L, P)
    Xh = xh * dth[..., None]                                 # x dt
    Bk, Ck = Bp.reshape(B, nc, 1, L, N), Cp.reshape(B, nc, 1, L, N)

    def mm(u, v):
        return matmul_3xtf32(u, v, products)

    G = Ck @ Bk.transpose(-1, -2) if bf16 else mm(Ck, Bk.transpose(-1, -2))
    if decays == "segments":
        seg = _segment_sums(ah)
        after = _suffix_after(ah)                # sum_{r>s} a[r]
        total = after[..., 0] + ah[..., 0]
    else:
        cs = _seq_cumsum(ah)
        seg = cs[..., :, None] - cs[..., None, :]
        after = cs[..., L - 1, None] - cs
        total = cs[..., L - 1]
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    M = torch.where(causal, torch.exp2(seg), torch.zeros(()))
    ends = mm((Xh * torch.exp2(after)[..., None]).transpose(-1, -2), Bk)
    decay = torch.exp2(total)                                # (B, nc, H)
    h = h0.float()
    starts = []
    for c in range(nc):
        starts.append(h)
        h = _fma(decay[:, c, :, None, None], h, ends[:, c])
    h_start = torch.stack(starts, 1)                         # (B, nc, H, P, N)
    e = torch.exp2(_seq_cumsum(ah))[..., None]               # (B, nc, H, L, 1)
    y = mm(M * G * dth[..., None, :], xh) \
        + mm(e * Ck, h_start.transpose(-1, -2))
    y = y.permute(0, 1, 3, 2, 4).reshape(B, nc * L, H, P)[:, :S]
    return y, h


def _inputs(seed, B, S, H, P, N, bf16):
    """dt selective (runs of 16 large steps, 3 + softplus noise, then 16
    small ones, 0.002 x the noise), A (H,) down to -80, x / Bc / Cc unit
    normal (bf16 values where ``bf16``), h0 nonzero."""
    rng = np.random.default_rng(seed)
    noise = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0))
    held = (np.arange(S) // 16 % 2 == 1)[None, :, None]
    dt = np.where(held, 0.002 * noise, 3.0 + noise)
    A = np.asarray(A_HEADS[:H])
    x = rng.standard_normal((B, S, H * P))
    Bc, Cc = rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N))
    h0 = 0.5 * rng.standard_normal((B, H, P, N))
    out = [torch.from_numpy(v.astype(np.float32))
           for v in (dt, A, x, Bc, Cc, h0)]
    if bf16:
        for i in (2, 3, 4):
            out[i] = out[i].bfloat16().float()
    return out


def _jax_scan(dt, A, x, Bc, Cc, h0):
    B, S, H = dt.shape
    dt, A, x, Bc, Cc, h0 = (jnp.asarray(t.numpy())
                            for t in (dt, A, x, Bc, Cc, h0))
    x_dt = x.reshape(B, S, H, -1) * dt[..., None]
    y, hT = _mamba2_scan(jnp.exp(dt * A), x_dt, Bc, Cc, h0)
    return np.asarray(y), np.asarray(hT)


def _rel_err(got, want, axis):
    """Each head's max |got - want| over its max |want| (heads on
    ``axis``)."""
    err = np.abs(got.numpy() - want)
    return [float(np.take(err, h, axis).max()
                  / np.abs(np.take(want, h, axis)).max())
            for h in range(want.shape[axis])]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("S", [1, 63, 64, 200])
def test_ssd_arithmetic_matches_jax(S, bf16):
    ins = _inputs(S + bf16, 2, S, 4, 64, 64, bf16)
    want_y, want_h = _jax_scan(*ins)
    y, hT = ssd_arithmetic(*ins, bf16=bf16)
    assert y.shape == want_y.shape and hT.shape == want_h.shape
    assert max(_rel_err(y, want_y, 2)) <= 1e-5
    assert max(_rel_err(hT, want_h, 1)) <= 1e-5


@pytest.mark.parametrize("control", ["cumsum_decays", "one_tf32_product"])
def test_ssd_negative_controls_miss(control):
    """At A -80 with selective dt (S 200: four chunks, the last ragged),
    either shortcut moves that head's y past 1e-4 of its max, where the
    kernels' arithmetic stays within 1e-5 (above)."""
    ins = _inputs(7, 2, 200, 4, 64, 64, False)
    want_y, _ = _jax_scan(*ins)
    kw = dict(decays="cumsum") if control == "cumsum_decays" \
        else dict(products=1)
    y, _ = ssd_arithmetic(*ins, bf16=False, **kw)
    assert A_HEADS[3] == -80.0
    assert _rel_err(y, want_y, 2)[3] > 1e-4


@pytest.mark.parametrize("S,P,N,want", [
    (1, 64, 64, "head_step"),       # a decode step
    (256, 64, 64, "ssd"),           # zamba2's prefill span
    (2, 64, 16, "ssd"),
    (2048, 64, 32, "ssd"),
    (77, 40, 32, "head_scan"),      # a head dim the chunked route lacks
    (130, 80, 64, "head_scan")])
def test_route_rule(S, P, N, want):
    assert kernel.body(S, P, N) == want


@pytest.mark.parametrize("head_chunks,H,slots,want", [
    (320, 80, 264, 1),        # zamba2's span: under four waves at 1
    (5120, 80, 264, 4),       # its training shape on an H100: 4.8 waves
    (5120, 80, 132, 8),       # 9.7 waves at 8: the cap
    (10 ** 6, 6, 396, 6),
    (1000, 7, 100, 1)])       # no divisor of 7 up to the cap of 5
def test_chunk_heads_rule(head_chunks, H, slots, want):
    assert kernel.chunk_heads_rule(head_chunks, H, slots) == want
