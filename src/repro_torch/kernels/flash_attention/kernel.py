"""K9: dense flash attention, hand-written for Hopper, and its wrapper.

Ports ``repro.kernels.flash_attention.kernel.flash_attention``.  The CUDA
kernel is in ``csrc/flash_attention.cu``, built by
``repro_torch.kernels.build``; ``ref.reference`` is the same function in
plain PyTorch.  Unlike the Pallas kernel, which takes (BH, S, d) with the
KV heads already repeated by ``ops.attend``, the kernel reads the model's
layout and maps query head ``h`` to KV head ``h // G`` itself.

The wrapper chooses by the tensors' device: on the CPU it runs the plain
version, on a CUDA device it launches the kernel or raises.  There is no
fallback.  ``flash_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, check_launch, count_launch,
                                      cuda_entry)
from repro_torch.kernels.flash_attention.ref import reference

HEAD_DIMS = (64, 128, 256)


def check_cuda_args(q, k, v) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"flash attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash attention: all tensors must be on one device")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention kernel takes float32 or bfloat16 "
                        f"q, k and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash attention kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash attention kernel needs 16-byte aligned "
                         "tensors")
    B, _, H, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[-1] != d or H % k.shape[2]:
        raise ValueError(f"flash attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """K9: q (B, Sq, H, d), k/v (B, Sk, KVH, d) -> (B, Sq, H, d) in q.dtype.

    CPU tensors run ``ref.reference``; CUDA tensors launch the Hopper kernel
    on the current stream, one CTA per 64-row tile of packed (token, head)
    query rows, KV head and batch row: fp32 runs the 3xTF32 tensor-core
    tile (``csrc/tf32_tile.cuh``; fp32-level error with TF32 off), bf16 the
    SIMT tile (``csrc/gqa_tile.cuh``; 32 rows at d = 256)."""
    if q.device.type == "cpu":
        return reference(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset)
    check_cuda_args(q, k, v)
    B, Sq, H, d = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = cuda_entry("flash_attention")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KVH, int(causal), window, q_offset,
        softcap, d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    count_launch(flash_attention)
    return out


flash_attention.launches = 0
