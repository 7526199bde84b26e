"""K8: block-sparse attention, hand-written for Hopper, its plain version
and its wrapper.

Ports ``repro.kernels.sparse_attention.kernel.block_sparse_attention`` in
the form the model needs (``core.dsa.sparse_block_attention``, the DSA
block selector's attention):

* q (B, S, H, dqk), k (B, T, KVH, dqk), v (B, T, KVH, dv): the model's
  layout; query head ``h`` reads KV head ``h // G`` (the Pallas wrapper
  repeats K/V G times instead), and dqk may differ from dv (MLA: 192 and
  256 at GLM-5's widths);
* block_idx (B, S/bs, nb) int32, shared by the heads of a batch row: query
  block ``n`` (queries ``n*bs .. n*bs+bs-1``) attends key block ``id``
  where ``id >= 0``; a negative entry ``id`` is skipped and stands for key
  block ``-id - 1`` (see ``empty_mean``); the attended ids of a row must be
  distinct;
* q_start (B,) int32: query ``i`` of row ``b`` sits at position
  ``q_start[b] + i``, key ``j`` at ``j`` (a serving span starts
  mid-sequence, a training chunk at its offset; 0 is the Pallas kernel's
  case).

A query attends the keys of its block's attended blocks at or before its
position and before T.  Scores are fp32, scaled by dqk^-1/2, soft-capped
``c*tanh(s/c)`` before masking; the softmax is exact.  A query that sees
no key gets 0 (the Pallas kernel's ``acc / max(l, 1e-20)``), or with
``empty_mean`` the mean of V over all nb·bs keys of the blocks its query
block lists, skipped ones included: what the reference's XLA
``sparse_block_attention`` gives there (a softmax over scores that are all
NEG_INF is uniform).  The block selector produces such rows (ROADMAP
queue 3: no diagonal block is ever marked valid), so the model's path
needs that rule.

The wrapper chooses by the tensors' device: on the CPU or meta it runs the plain
version, on a CUDA device it launches the kernel (``csrc/block_sparse.cu``,
built by ``repro_torch.kernels.build``) or raises.  There is no fallback.
Both dtypes run on the tensor cores, with K/V in a cp.async ring and each
tile's selected keys split over up to 4 CTAs with a combine pass when that
fills the card better (``key_split``, from the shapes and the body's
occupancy query): bf16 (the serving path) the tile of
``csrc/mma_tile.cuh`` (mma.sync on bf16), fp32 (training, the exact parity
runs) the tile of ``csrc/tf32_tile.cuh`` (3xTF32: each fp32 operand split
into two TF32 values and three products summed in fp32, so its error stays
at fp32 level with TF32 off), at every (dqk, dv) in ``HEAD_DIMS``.
``block_sparse_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import (DTYPE_CODE, check_launch,
                                      count_launch, cuda_entry, key_split,
                                      resources)

NEG_INF = -1e30
MAX_BLOCKS = 64                          # nb the kernel takes (csrc)
HEAD_DIMS = ((64, 64), (128, 128), (192, 256))   # (dqk, dv) instantiated


def block_sparse_attention_plain(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, block_idx: torch.Tensor,
                                 q_start: torch.Tensor, *, block_size: int,
                                 softcap: float = 0.0,
                                 empty_mean: bool = False) -> torch.Tensor:
    """K8's function in plain PyTorch (differentiable): each query block
    gathers its listed blocks' K/V (B, nqb, nb·bs, KVH, d) and attends
    them; the arguments are the kernel's."""
    B, S, H, dqk = q.shape
    T, KVH = k.shape[1], k.shape[2]
    G, bs = H // KVH, block_size
    nqb, nb = block_idx.shape[1], block_idx.shape[2]
    ids = block_idx.long()
    blocks = torch.where(ids >= 0, ids, -ids - 1)
    offs = torch.arange(bs, device=q.device)
    tok = (blocks[..., None] * bs + offs).reshape(B, nqb, nb * bs)
    admit = (ids >= 0)[..., None].expand(B, nqb, nb, bs).reshape(tok.shape)
    admit = admit & (tok < T)
    rows = torch.arange(B, device=q.device)[:, None]
    gather = tok.clamp(max=T - 1).reshape(B, -1)
    k_sel = k[rows, gather].reshape(B, nqb, nb * bs, KVH, dqk).float()
    v_sel = v[rows, gather].reshape(B, nqb, nb * bs, KVH, -1).float()
    qpos = (q_start.long()[:, None]
            + torch.arange(S, device=q.device)).reshape(B, nqb, bs)
    ok = admit[:, :, None, :] & (tok[:, :, None, :] <= qpos[..., None])
    qg = q.float().reshape(B, nqb, bs, KVH, G, dqk)
    s = torch.einsum("bnqjgd,bnkjd->bnjgqk", qg, k_sel) * dqk ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    okb = ok[:, :, None, None]                         # (B, nqb, 1, 1, bs, K)
    s = torch.where(okb, s, NEG_INF)
    p = torch.where(okb, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bnjgqk,bnkjd->bnjgqd", p, v_sel) / l.clamp_min(1e-20)
    if empty_mean:
        mean = v_sel.mean(dim=2)                       # (B, nqb, KVH, dv)
        o = torch.where(l > 0, o, mean[:, :, :, None, None, :])
    out = o.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, -1)
    return out.to(q.dtype)


def check_cuda_args(q, k, v, block_idx, q_start, block_size) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if q.device.type != "cuda":
        raise ValueError(f"block-sparse kernel runs on CUDA tensors, got "
                         f"{q.device}")
    if any(t.device != q.device for t in (k, v, block_idx, q_start)):
        raise ValueError("block-sparse attention: all tensors must be on "
                         "one device")
    if q.dtype not in DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"block-sparse kernel takes float32 or bfloat16 q, "
                        f"k and v of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if block_idx.dtype != torch.int32 or q_start.dtype != torch.int32:
        raise TypeError("block-sparse kernel takes int32 block_idx and "
                        "q_start")
    if not all(t.is_contiguous() for t in (q, k, v, block_idx, q_start)):
        raise ValueError("block-sparse kernel needs contiguous tensors")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("block-sparse kernel needs 16-byte aligned tensors")
    B, S, H, dqk = q.shape
    if k.ndim != 4 or v.ndim != 4 or k.shape[:3] != v.shape[:3] \
            or k.shape[0] != B or k.shape[-1] != dqk or H % k.shape[2]:
        raise ValueError(f"block-sparse attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if (dqk, v.shape[-1]) not in HEAD_DIMS:
        raise ValueError(f"block-sparse kernel: (dqk, dv) = "
                         f"{(dqk, v.shape[-1])} not in {HEAD_DIMS}")
    if S % block_size or block_idx.shape[:2] != (B, S // block_size) \
            or not 0 < block_idx.shape[2] <= MAX_BLOCKS:
        raise ValueError(f"block-sparse attention: block_idx "
                         f"{tuple(block_idx.shape)} for S {S}, block size "
                         f"{block_size} (nb <= {MAX_BLOCKS})")
    if q_start.shape != (B,):
        raise ValueError(f"block-sparse attention: q_start "
                         f"{tuple(q_start.shape)}, want ({B},)")


def launch_block_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_idx: torch.Tensor, q_start: torch.Tensor, *,
                        block_size: int, softcap: float, empty_mean: bool,
                        parts: int) -> torch.Tensor:
    """K8's C entry point on checked CUDA tensors with each tile's keys
    split over ``parts`` CTAs (1..4; the combine pass's workspace from
    PyTorch's caching allocator) -> out.  Counts nothing: the wrapper does,
    and the tests call this to force ``parts``."""
    B, S, H, dqk = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    per_cta = resources("block_sparse_resources", DTYPE_CODE[q.dtype], dqk,
                        dv)[4]
    tiles = -(-block_size * (H // KVH) // per_cta) * (S // block_size) \
        * B * KVH
    ws = None if parts == 1 else torch.empty(
        tiles * parts * per_cta * (dv + 2), dtype=torch.float32,
        device=q.device)
    return _launch(q, k, v, block_idx, q_start, block_size, softcap,
                   empty_mean, parts, ws)


def _launch(q, k, v, block_idx, q_start, block_size, softcap, empty_mean,
            parts, ws) -> torch.Tensor:
    B, S, H, dqk = q.shape
    T, KVH, dv = k.shape[1], k.shape[2], v.shape[-1]
    out = torch.empty((B, S, H, dv), dtype=q.dtype, device=q.device)
    err = cuda_entry("block_sparse_attention")(
        DTYPE_CODE[q.dtype], dqk, dv, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), block_idx.data_ptr(), q_start.data_ptr(),
        out.data_ptr(), B, S, T, H, KVH, block_size, block_idx.shape[2],
        int(empty_mean), softcap, dqk ** -0.5, parts,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    check_launch("block_sparse_attention", err)
    return out


def block_sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_idx: torch.Tensor, q_start: torch.Tensor, *,
                           block_size: int, softcap: float = 0.0,
                           empty_mean: bool = False) -> torch.Tensor:
    """K8: -> (B, S, H, dv) in q.dtype.

    CPU and meta tensors run ``block_sparse_attention_plain``; CUDA tensors launch
    the Hopper kernel on the current stream (one CTA per tile of packed
    (token, head) rows of one query block, KV head and batch row, times the
    key-range parts): bf16 the bf16 tensor-core tile, fp32 the 3xTF32 tile,
    and, when the keys are split, the combine pass (one launch counted)."""
    if q.device.type in ("cpu", "meta"):
        return block_sparse_attention_plain(
            q, k, v, block_idx, q_start, block_size=block_size,
            softcap=softcap, empty_mean=empty_mean)
    check_cuda_args(q, k, v, block_idx, q_start, block_size)
    B, S, H, dqk = q.shape
    KVH, dv = k.shape[2], v.shape[-1]
    parts, ws = key_split("block_sparse_resources",
                          (DTYPE_CODE[q.dtype], dqk, dv),
                          block_size * (H // KVH),
                          (S // block_size) * B * KVH, dv, q.device)
    out = _launch(q, k, v, block_idx, q_start, block_size, softcap,
                  empty_mean, parts, ws)
    count_launch(block_sparse_attention)
    return out


block_sparse_attention.launches = 0
