"""K10: fused output projection + cross-entropy, hand-written for Hopper.

Ports ``repro.kernels.chunked_ce.kernel.chunked_ce``: the masked sum of
token NLLs and the mask's sum, without (tokens, V) logits in device memory.
The CUDA kernel is in ``csrc/chunked_ce.cu``, built by
``repro_torch.kernels.build``; ``ref.reference`` is the same function in
plain PyTorch.  As in the reference, the kernel gives one partial sum per
128-token tile and the wrapper sums them; the order of the sums differs
from the plain version's (fp32 agreement to ~1e-6 relative).

The wrapper chooses by the tensors' device: on the CPU or meta it runs the plain
version, on a CUDA device it launches the kernel or raises.  There is no
fallback.  ``chunked_ce.launches`` counts kernel launches (one a call: the
logits-tile pass and the per-token combine pass it starts together).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.build import (DTYPE_CODE, check_launch, count_launch,
                                      cuda_entry)
from repro_torch.kernels.build import refuse_dtensor
from repro_torch.kernels.chunked_ce.ref import reference

BLOCK_T, BLOCK_V = 128, 128      # the kernel's token and vocab tiles


def check_cuda_args(h, w, targets, mask) -> None:
    """Raise on anything the CUDA kernel does not take."""
    tensors = (h, w, targets, mask)
    if h.device.type != "cuda":
        raise ValueError(f"chunked CE kernel runs on CUDA tensors, got "
                         f"{h.device}")
    if any(t.device != h.device for t in tensors):
        raise ValueError("chunked CE: all tensors must be on one device")
    if h.dtype not in DTYPE_CODE or w.dtype != h.dtype:
        raise TypeError(f"chunked CE kernel takes float32 or bfloat16 h and "
                        f"w of one dtype, got {h.dtype}, {w.dtype}")
    if targets.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError("chunked CE: targets must be int32, mask float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("chunked CE kernel needs contiguous tensors")
    Tk, D = h.shape
    if w.ndim != 2 or w.shape[0] != D or targets.shape != (Tk,) \
            or mask.shape != (Tk,):
        raise ValueError(f"chunked CE: h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, targets {tuple(targets.shape)}, "
                         f"mask {tuple(mask.shape)} do not match")


def chunked_ce(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, *, softcap: float = 0.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10: h (Tk, D), w (D, V), targets (Tk,) int32, mask (Tk,) float32
    -> (loss_sum, count), fp32 scalars.

    CPU and meta tensors run ``ref.reference``; CUDA tensors launch the Hopper
    kernel on the current stream (a CTA per 128-token x 128-vocab logits
    tile, then a combine pass per 128 tokens)."""
    refuse_dtensor("chunked_ce", h, w, targets, mask)
    if h.device.type in ("cpu", "meta"):
        return reference(h, w, targets, mask, softcap=softcap)
    check_cuda_args(h, w, targets, mask)
    Tk, D = h.shape
    V = w.shape[1]
    n_tt, n_vt = -(-Tk // BLOCK_T), -(-V // BLOCK_V)
    part = torch.empty(3 * n_vt * Tk, dtype=torch.float32, device=h.device)
    sums = torch.empty((2, n_tt), dtype=torch.float32, device=h.device)
    err = cuda_entry("chunked_ce")(
        DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(), targets.data_ptr(),
        mask.data_ptr(), part.data_ptr(), sums[0].data_ptr(),
        sums[1].data_ptr(), Tk, D, V, softcap,
        torch.cuda.current_stream(h.device).cuda_stream)
    check_launch("chunked_ce", err)
    count_launch(chunked_ce)
    loss, count = sums.sum(1)
    return loss, count


chunked_ce.launches = 0
