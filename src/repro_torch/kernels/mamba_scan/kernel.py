"""K11: the Mamba-1 selective scan, hand-written for Hopper, its wrappers
and the autograd Function of the model's form.

Ports ``repro.kernels.mamba_scan.kernel.mamba_scan`` (the recurrence
``h[t] = dA[t]·h[t-1] + dBx[t]``, ``y[t] = <h[t], C[t]>``; see ``ref.py``)
with two entry points over one CUDA body (``csrc/mamba_scan.cu``, built by
``repro_torch.kernels.build``):

* ``mamba_scan(dA, dBx, C, h0)``: the Pallas kernel's contract, for the
  parity tests; y and hT in ``dA.dtype``;
* ``mamba_scan_model(dt, A, x, Bc, Cc, h0)``: the tensors
  ``layers.ssm.apply_mamba1`` has; the kernel discretizes
  (``dA = exp(dt·A)``, ``dBx = (dt·x)·B``) itself, so the (B, S, E, N)
  dA and dBx never reach device memory; y and hT in fp32.  dt, x, Bc and
  Cc are in the model's dtype (float32 or bfloat16), A fp32, h0 fp32 or
  bfloat16.

N (the state size) must divide 32 (a warp holds whole channels, a lane per
(channel, state) pair); E and S >= 1 are free.  ``mamba1_scan`` is the
model's entry point: an autograd Function whose forward is
``mamba_scan_model`` and whose backward is the plain recomputing gradient
``ref.scan_model_grads`` (the reference differentiates its ``lax.scan``;
no backward kernel yet).

The wrappers choose by the tensors' device: on the CPU they run the plain
versions, on a CUDA device they launch the kernel or raise.  There is no
fallback.  ``mamba_scan.launches`` and ``mamba_scan_model.launches`` count
kernel launches.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import DTYPE_CODE, check_launch, cuda_entry
from repro_torch.kernels.mamba_scan.ref import (reference, scan_model,
                                                scan_model_grads)

STATE_SIZES = (1, 2, 4, 8, 16, 32)     # N: divides the 32 lanes of a warp
MAX_BATCH = 65535                      # the grid's y dimension


def _check_common(name, tensors, B, S, E, N) -> None:
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name} kernel runs on CUDA tensors, got "
                         f"{first.device}")
    if any(t.device != first.device for t in tensors):
        raise ValueError(f"{name}: all tensors must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    if N not in STATE_SIZES:
        raise ValueError(f"{name} kernel: state size {N} must divide 32 "
                         f"{STATE_SIZES}")
    if not (1 <= B <= MAX_BATCH and S >= 1 and E >= 1):
        raise ValueError(f"{name} kernel: B={B} (1..{MAX_BATCH}), S={S} and "
                         f"E={E} (>= 1)")


def check_cuda_args(dA, dBx, C, h0) -> None:
    """Raise on anything the contract form of the kernel does not take."""
    if dA.ndim != 4:
        raise ValueError(f"mamba_scan: dA {tuple(dA.shape)}, want "
                         f"(B, S, E, N)")
    B, S, E, N = dA.shape
    _check_common("mamba_scan", (dA, dBx, C, h0), B, S, E, N)
    if dA.dtype not in DTYPE_CODE or any(t.dtype != dA.dtype
                                         for t in (dBx, C, h0)):
        raise TypeError(f"mamba_scan kernel takes float32 or bfloat16 dA, "
                        f"dBx, C and h0 of one dtype, got {dA.dtype}, "
                        f"{dBx.dtype}, {C.dtype}, {h0.dtype}")
    if dBx.shape != dA.shape or C.shape != (B, S, N) \
            or h0.shape != (B, E, N):
        raise ValueError(f"mamba_scan: dBx {tuple(dBx.shape)}, C "
                         f"{tuple(C.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match dA {tuple(dA.shape)}")


def check_cuda_args_model(dt, A, x, Bc, Cc, h0) -> None:
    """Raise on anything the model form of the kernel does not take."""
    if dt.ndim != 3 or A.ndim != 2:
        raise ValueError(f"mamba_scan_model: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, want (B, S, E) and (E, N)")
    (B, S, E), N = dt.shape, A.shape[1]
    _check_common("mamba_scan_model", (dt, A, x, Bc, Cc, h0), B, S, E, N)
    if dt.dtype not in DTYPE_CODE or any(t.dtype != dt.dtype
                                         for t in (x, Bc, Cc)):
        raise TypeError(f"mamba_scan_model kernel takes float32 or bfloat16 "
                        f"dt, x, Bc and Cc of one dtype, got {dt.dtype}, "
                        f"{x.dtype}, {Bc.dtype}, {Cc.dtype}")
    if A.dtype != torch.float32 or h0.dtype not in DTYPE_CODE:
        raise TypeError(f"mamba_scan_model kernel takes float32 A and a "
                        f"float32 or bfloat16 h0, got {A.dtype}, {h0.dtype}")
    if x.shape != dt.shape or A.shape != (E, N) or Bc.shape != (B, S, N) \
            or Cc.shape != (B, S, N) or h0.shape != (B, E, N):
        raise ValueError(f"mamba_scan_model: x {tuple(x.shape)}, A "
                         f"{tuple(A.shape)}, Bc {tuple(Bc.shape)}, Cc "
                         f"{tuple(Cc.shape)}, h0 {tuple(h0.shape)} do not "
                         f"match dt {tuple(dt.shape)}")


def mamba_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11, the Pallas contract: -> (y (B, S, E), hT (B, E, N)) in dA.dtype.

    CPU tensors run ``ref.reference``; CUDA tensors launch the Hopper
    kernel on the current stream (one CTA per 256/N channels of a batch
    row)."""
    if dA.device.type == "cpu":
        return reference(dA, dBx, C, h0)
    check_cuda_args(dA, dBx, C, h0)
    B, S, E, N = dA.shape
    y = torch.empty((B, S, E), dtype=dA.dtype, device=dA.device)
    hT = torch.empty((B, E, N), dtype=dA.dtype, device=dA.device)
    err = cuda_entry("mamba_scan_contract")(
        DTYPE_CODE[dA.dtype], N, dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, E,
        torch.cuda.current_stream(dA.device).cuda_stream)
    check_launch("mamba_scan_contract", err)
    mamba_scan.launches += 1
    return y, hT


mamba_scan.launches = 0


def mamba_scan_model(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                     Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11, the model's form: -> (y (B, S, E), hT (B, E, N)) in fp32.

    CPU tensors run ``ref.scan_model``; CUDA tensors launch the Hopper
    kernel on the current stream."""
    if dt.device.type == "cpu":
        return scan_model(dt, A, x, Bc, Cc, h0)
    check_cuda_args_model(dt, A, x, Bc, Cc, h0)
    (B, S, E), N = dt.shape, A.shape[1]
    y = torch.empty((B, S, E), dtype=torch.float32, device=dt.device)
    hT = torch.empty((B, E, N), dtype=torch.float32, device=dt.device)
    err = cuda_entry("mamba_scan_model")(
        DTYPE_CODE[dt.dtype], DTYPE_CODE[h0.dtype], N, dt.data_ptr(),
        A.data_ptr(), x.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
        h0.data_ptr(), y.data_ptr(), hT.data_ptr(), B, S, E,
        torch.cuda.current_stream(dt.device).cuda_stream)
    check_launch("mamba_scan_model", err)
    mamba_scan_model.launches += 1
    return y, hT


mamba_scan_model.launches = 0


class _MambaScan(torch.autograd.Function):
    """K11's model form forward; the backward is ``ref.scan_model_grads``,
    which recomputes the states from the inputs ``ref.BWD_CHUNK`` steps at
    a time (never from the forward's outputs)."""

    @staticmethod
    def forward(ctx, dt, A, x, Bc, Cc, h0):
        ctx.save_for_backward(dt, A, x, Bc, Cc, h0)
        return mamba_scan_model(dt, A, x, Bc, Cc, h0)

    @staticmethod
    def backward(ctx, g_y, g_hT):
        ins = ctx.saved_tensors
        grads = scan_model_grads(*ins, g_y, g_hT)
        return tuple(g.to(t.dtype) for g, t in zip(grads, ins))


def mamba1_scan(dt: torch.Tensor, A: torch.Tensor, x: torch.Tensor,
                Bc: torch.Tensor, Cc: torch.Tensor, h0: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of ``apply_mamba1``, differentiable: dt and x
    (B, S, E), A (E, N) fp32, Bc and Cc (B, S, N), h0 (B, E, N) -> (y, hT)
    in fp32."""
    return _MambaScan.apply(dt.contiguous(), A.contiguous(), x.contiguous(),
                            Bc.contiguous(), Cc.contiguous(),
                            h0.contiguous())
