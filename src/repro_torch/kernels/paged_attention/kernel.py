"""K1: paged GQA flash-decode, hand-written for Hopper, and its plain version.

Port of ``repro.kernels.paged_attention.kernel.paged_decode_gqa`` (the
Pallas TPU kernel).  The CUDA kernel is in ``csrc/paged_attention.cu``
(built by ``repro_torch.kernels.build``); ``paged_decode_gqa_plain`` is the
same function in plain PyTorch — the counterpart of the reference's XLA
twin ``ops._blocked_gqa``: a loop over live blocks with the same masks and
the same fp32 online softmax.

Addressing contract (as the reference): position ``p`` of row ``b`` lives
at ``(tables[b, p // bs], p % bs)``; ``seq_lens[b]`` is the query's
position (its K/V were scattered before the call) and attention covers
positions ``<= seq_lens[b]``; idle slots point at the trash block with
length 0 and still get a finite output.

``paged_decode_gqa`` chooses by the tensors' device: on the CPU it runs the
plain version, on a CUDA device it launches the kernel or raises.  There
is no fallback.  ``paged_decode_gqa.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
BLOCK_SIZES = (8, 16, 32)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
_ARGTYPES = {
    "paged_decode_gqa": [_I] * 3 + [_P] * 6 + [_I] * 5 + [_F, _F, _P],
    "paged_prefill_gqa": [_I] * 3 + [_P] * 6 + [_I] * 6 + [_F, _F, _P],
}


@functools.lru_cache(maxsize=None)
def cuda_entry(name: str):
    """The C entry point ``name`` of the paged-attention library, with its
    argument types declared (built at first use)."""
    fn = getattr(build.load("paged_attention"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def check_cuda_args(q, k_pool, v_pool, block_tables, positions) -> None:
    """Raise on anything the CUDA kernels do not take."""
    tensors = (q, k_pool, v_pool, block_tables, positions)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged attention: all tensors must be on one device")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("paged attention: q and the pools must share a dtype")
    if block_tables.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError("paged attention: tables and positions must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention kernel needs contiguous tensors")
    d, bs = q.shape[-1], k_pool.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"paged attention kernel: head_dim {d} not in "
                         f"{HEAD_DIMS}")
    if bs not in BLOCK_SIZES:
        raise ValueError(f"paged attention kernel: block size {bs} not in "
                         f"{BLOCK_SIZES}")
    if k_pool.shape != v_pool.shape or k_pool.shape[-1] != d \
            or k_pool.shape[2] != q.shape[1]:
        raise ValueError(f"paged attention: pools {tuple(k_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if block_tables.shape[0] != q.shape[0] or positions.shape != (q.shape[0],):
        raise ValueError("paged attention: tables/positions batch mismatch")


def paged_decode_gqa_plain(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           seq_lens: torch.Tensor, *, window: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch K1: q (B, KVH, G, d); pools (nb, bs, KVH, d); tables
    (B, mb); seq_lens (B,) -> (B, KVH, G, d) in q.dtype.  Folds the blocks
    up to the batch's longest row one at a time (fp32 online softmax)."""
    B, KVH, G, d = q.shape
    bs = k_pool.shape[1]
    scale = d ** -0.5
    qf = q.float()
    lens = seq_lens.long()
    n_live = int(lens.max()) // bs + 1
    m = torch.full((B, KVH, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, KVH, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, G, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(n_live):
        blk = block_tables[:, j].long()
        kb = k_pool[blk].float()                       # (B, bs, KVH, d)
        vb = v_pool[blk].float()
        s = torch.einsum("bkgd,btkd->bkgt", qf, kb) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = j * bs + offs
        mask = k_pos[None, :] <= lens[:, None]
        if window > 0:
            mask &= (lens[:, None] - k_pos[None, :]) < window
        mask = mask[:, None, None, :]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgt,btkd->bkgd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def paged_decode_gqa(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """K1: q (B, KVH, G, d); k/v pools (nb, bs, KVH, d); tables (B, mb)
    int32; seq_lens (B,) int32 -> (B, KVH, G, d) in q.dtype.

    CPU tensors run ``paged_decode_gqa_plain``; CUDA tensors launch the
    Hopper kernel on the current stream (one CTA per (kv-head, row))."""
    if q.device.type == "cpu":
        return paged_decode_gqa_plain(q, k_pool, v_pool, block_tables,
                                      seq_lens, window=window,
                                      softcap=softcap)
    check_cuda_args(q, k_pool, v_pool, block_tables, seq_lens)
    B, KVH, G, d = q.shape
    out = torch.empty_like(q)
    err = cuda_entry("paged_decode_gqa")(
        _DTYPE_CODE[q.dtype], d, k_pool.shape[1], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, KVH, G,
        block_tables.shape[1], window, softcap, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_gqa launch failed: cudaError {err}")
    paged_decode_gqa.launches += 1
    return out


paged_decode_gqa.launches = 0
