"""K9: dense flash attention, hand-written for Hopper, and its wrapper.

Ports ``repro.kernels.flash_attention.kernel.flash_attention``.  The CUDA
kernel is in ``csrc/flash_attention.cu``, built by
``repro_torch.kernels.build``; ``ref.reference`` is the same function in
plain PyTorch.  Unlike the Pallas kernel, which takes (BH, S, d) with the
KV heads already repeated by ``ops.attend``, the kernel reads the model's
layout and maps query head ``h`` to KV head ``h // G`` itself.

Both dtypes run a tensor-core tile: fp32 the 3xTF32 tile
(``csrc/tf32_tile.cuh``), bf16 the bf16 tile K2 and K8 share
(``csrc/mma_tile.cuh``; P rounded to bf16 for PV, so it is held at the
bf16 bound).  bf16 splits each tile's keys over ``parts`` CTAs, with a
combine pass, where the tiles leave SMs empty (``bf16_parts``); fp32 takes
parts 1 (its training grid fills the card).  ``launch_flash_attention``
forces a split (tests, ``chip_smoke.py``).

The wrapper chooses by the tensors' device: on the CPU or meta it runs the plain
version, on a CUDA device it launches the kernel or raises.  There is no
fallback.  ``flash_attention.launches`` counts wrapper calls that launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, MAX_PARTS, check_launch,
                                      count_launch, cuda_entry, resources)
from repro_torch.kernels.flash_attention.ref import reference

HEAD_DIMS = (64, 80, 96, 128, 256)


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


# (d, packed rows, B * KVH, device index) -> parts of a bf16 call
_PARTS: dict = {}


def bf16_parts(d: int, rows: int, others: int,
               device: torch.device) -> int:
    """The parts of a bf16 call with ``rows`` packed query rows (Sq * G) a
    (batch row, KV head) and ``others`` = B * KVH of them: each tile's keys
    split over as many CTAs as leave one an SM (not one a CTA slot, as K2
    and K8 split: at the RL loop shape, 120 tiles for 132 SMs, a second CTA
    an SM and the combine pass measured 15 % slower than none; at d 256, 32
    tiles, 4 parts 27 % faster than 1), at most ``MAX_PARTS``.  Looked up
    once a shape: the wrapper's host time is the loop shape's floor."""
    key = (d, rows, others, device.index)
    parts = _PARTS.get(key)
    if parts is None:
        per_cta = resources("flash_attention_resources", 1, d)[4]
        tiles = -(-rows // per_cta) * others
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        parts = _PARTS[key] = max(1, min(MAX_PARTS, sms // tiles))
    return parts


def split_workspace(q: torch.Tensor, k: torch.Tensor,
                    parts: int) -> torch.Tensor | None:
    """The fp32 workspace of a call split over ``parts`` (tiles x parts x
    rows a CTA x (d + 2) floats, from PyTorch's caching allocator), or None
    at parts 1."""
    if parts == 1:
        return None
    B, Sq, H, d = q.shape
    KVH = k.shape[2]
    per_cta = resources("flash_attention_resources", DTYPE_CODE[q.dtype],
                        d)[4]
    tiles = -(-Sq * (H // KVH) // per_cta) * B * KVH
    return torch.empty(tiles * parts * per_cta * (d + 2),
                       dtype=torch.float32, device=q.device)


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, softcap: float = 0.0,
                           q_offset: int = 0, parts: int) -> torch.Tensor:
    """K9's C entry point on CUDA tensors with each tile's keys split over
    ``parts`` CTAs (1..4) -> out.  Counts nothing: the wrapper does, and
    the tests call this to force ``parts``."""
    check_cuda_args(q, k, v)
    return _launch(q, k, v, causal, window, softcap, q_offset, parts,
                   split_workspace(q, k, parts))


def _launch(q, k, v, causal, window, softcap, q_offset, parts, ws):
    B, Sq, H, d = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    err = cuda_entry("flash_attention")(
        DTYPE_CODE[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KVH, int(causal), window, q_offset,
        softcap, d ** -0.5, parts, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("flash_attention", err)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """K9: q (B, Sq, H, d), k/v (B, Sk, KVH, d) -> (B, Sq, H, d) in q.dtype.

    CPU and meta tensors run ``ref.reference``; CUDA tensors launch the Hopper kernel
    on the current stream, one CTA per 64-row tile of packed (token, head)
    query rows, KV head and batch row: fp32 runs the 3xTF32 tensor-core
    tile (``csrc/tf32_tile.cuh``; fp32-level error with TF32 off), bf16 the
    bf16 tensor-core tile (``csrc/mma_tile.cuh``), its keys split over the
    parts ``bf16_parts`` picks, with the combine pass where that is more
    than 1 (one launch counted)."""
    if q.device.type in ("cpu", "meta"):
        return reference(q, k, v, causal=causal, window=window,
                         softcap=softcap, q_offset=q_offset)
    check_cuda_args(q, k, v)
    B, Sq, H, d = q.shape
    KVH = k.shape[2]
    parts = 1
    if q.dtype == torch.bfloat16:
        parts = bf16_parts(d, Sq * (H // KVH), B * KVH, q.device)
    out = _launch(q, k, v, causal, window, softcap, q_offset, parts,
                  split_workspace(q, k, parts))
    count_launch(flash_attention)
    return out


flash_attention.launches = 0
