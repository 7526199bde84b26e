"""K7: lightning-indexer scores over contiguous keys, hand-written for
Hopper.

Ports ``repro.kernels.lightning_indexer.kernel.lightning_indexer``: the
DSA indexer scores of every query against every key, with score, ReLU and
the head-weighted sum fused.  The CUDA kernel is in
``csrc/lightning_indexer.cu``, built by ``repro_torch.kernels.build``: at
Hi 8, 16 or 32 K6's tensor-core body (``csrc/indexer_mma.cuh``) over
contiguous keys, bf16 on ``mma.sync`` and fp32 by 3xTF32 (fp32-level
error); at other head counts the SIMT tile (``body`` names the route of a
shape).  ``ref.reference`` is the same
function in plain PyTorch.  The kernel takes K6's index head dims and
width (Di 16/32/64/128, Hi·Di <= 8192).

The wrapper chooses by the tensors' device: on the CPU or meta it runs the plain
version, on a CUDA device it launches the kernel or raises.  There is no
fallback.  ``lightning_indexer.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, check_launch, count_launch,
                                      cuda_entry)
from repro_torch.kernels.build import refuse_dtensor
from repro_torch.kernels.lightning_indexer.ref import reference

INDEX_DIMS = (16, 32, 64, 128)
INDEX_WIDTH = 8192               # max Hi*Di: a token's fp32 queries, 32 KB
MMA_HEADS = (8, 16, 32)          # head counts the tensor-core body takes


def body(heads: int, head_dim: int) -> str:
    """The CUDA body a call of ``heads`` x ``head_dim`` runs, in both
    dtypes: ``indexer_mma`` (the tensor cores) or ``indexer_tile`` (the
    SIMT tile)."""
    return "indexer_mma" if heads in MMA_HEADS and head_dim in INDEX_DIMS \
        else "indexer_tile"


def check_cuda_args(q_idx, w_head, k_idx, heads: int, head_dim: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    tensors = (q_idx, w_head, k_idx)
    if q_idx.device.type != "cuda":
        raise ValueError(f"lightning indexer kernel runs on CUDA tensors, got "
                         f"{q_idx.device}")
    if any(t.device != q_idx.device for t in tensors):
        raise ValueError("lightning indexer: all tensors must be on one "
                         "device")
    if q_idx.dtype not in DTYPE_CODE or k_idx.dtype != q_idx.dtype:
        raise TypeError(f"lightning indexer kernel takes float32 or bfloat16 "
                        f"q_idx and k_idx of one dtype, got {q_idx.dtype}, "
                        f"{k_idx.dtype}")
    if w_head.dtype != torch.float32:
        raise TypeError(f"lightning indexer: head weights must be float32, "
                        f"got {w_head.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lightning indexer kernel needs contiguous tensors")
    if q_idx.data_ptr() % 16 or k_idx.data_ptr() % 16:
        raise ValueError("lightning indexer kernel needs 16-byte aligned "
                         "q_idx and k_idx")
    if head_dim not in INDEX_DIMS or heads * head_dim > INDEX_WIDTH:
        raise ValueError(f"lightning indexer kernel: {heads} heads x "
                         f"{head_dim} (head dims {INDEX_DIMS}, at most "
                         f"{INDEX_WIDTH} wide)")
    B, S, width = q_idx.shape
    if width != heads * head_dim or w_head.shape != (B, S, heads) \
            or k_idx.ndim != 3 or k_idx.shape[0] != B \
            or k_idx.shape[2] != head_dim:
        raise ValueError(f"lightning indexer: q_idx {tuple(q_idx.shape)}, "
                         f"w_head {tuple(w_head.shape)}, k_idx "
                         f"{tuple(k_idx.shape)} do not match {heads} heads "
                         f"x {head_dim}")


def lightning_indexer(q_idx: torch.Tensor, w_head: torch.Tensor,
                      k_idx: torch.Tensor, *, heads: int,
                      head_dim: int) -> torch.Tensor:
    """K7: q_idx (B, S, Hi*Di), w_head (B, S, Hi) fp32 (softmaxed), k_idx
    (B, T, Di) -> scores (B, S, T) fp32.

    CPU and meta tensors run ``ref.reference``; CUDA tensors launch the Hopper
    kernel on the current stream (on ``body``'s route: at Hi 8 / 16 / 32
    a CTA per chunk of keys and group of tokens of a batch row, on the
    tensor cores)."""
    refuse_dtensor("lightning_indexer", q_idx, w_head, k_idx)
    if q_idx.device.type in ("cpu", "meta"):
        return reference(q_idx, w_head, k_idx, heads=heads,
                         head_dim=head_dim)
    check_cuda_args(q_idx, w_head, k_idx, heads, head_dim)
    B, S, _ = q_idx.shape
    T = k_idx.shape[1]
    out = torch.empty((B, S, T), dtype=torch.float32, device=q_idx.device)
    err = cuda_entry("lightning_indexer")(
        DTYPE_CODE[q_idx.dtype], head_dim, q_idx.data_ptr(),
        w_head.data_ptr(), k_idx.data_ptr(), out.data_ptr(), B, S, T, heads,
        head_dim ** -0.5, torch.cuda.current_stream(q_idx.device).cuda_stream)
    check_launch("lightning_indexer", err)
    count_launch(lightning_indexer)
    return out


lightning_indexer.launches = 0
