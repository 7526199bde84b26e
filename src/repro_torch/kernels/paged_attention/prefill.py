"""K2: paged GQA span prefill, hand-written for Hopper, and its plain version.

Port of ``repro.kernels.paged_attention.prefill.paged_prefill_gqa`` (the
Pallas TPU kernel).  A span is S consecutive tokens of one sequence; query
``i`` of row ``b`` sits at absolute position ``starts[b] + i`` and its K/V
were scattered through the table before the call.  Attention is causal by
absolute position: full attention to the cached prefix, causal within the
span, optionally windowed and soft-capped.

Queries come packed as in the reference: (B, KVH, S*G, d), row ``i*G + g``
is group query ``g`` of span token ``i``.  The CUDA kernel
(``csrc/paged_attention.cu``) tiles those rows — the Pallas kernel keeps the
whole span resident in VMEM, which no Hopper shared memory holds — and each
tile stops at the block of its own last query position.

``paged_prefill_gqa`` runs the plain version on CPU tensors and launches the
kernel on CUDA tensors, or raises; ``paged_prefill_gqa.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import (NEG_INF, _DTYPE_CODE,
                                                        check_cuda_args,
                                                        cuda_entry)


def paged_prefill_gqa_plain(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_tables: torch.Tensor,
                            starts: torch.Tensor, *, groups: int,
                            window: int = 0,
                            softcap: float = 0.0) -> torch.Tensor:
    """Plain PyTorch K2 (counterpart of the reference's
    ``ops._blocked_gqa_prefill``): q (B, KVH, S*G, d) packed -> same shape,
    folding blocks up to the batch's last span position."""
    B, KVH, SG, d = q.shape
    G = groups
    if SG % G:
        raise ValueError(f"packed rows {SG} not a multiple of groups {G}")
    S = SG // G
    bs = k_pool.shape[1]
    scale = d ** -0.5
    qf = q.float()
    st = starts.long()
    qpos = st[:, None] + torch.arange(SG, device=q.device)[None] // G  # (B,SG)
    n_live = (int(st.max()) + S - 1) // bs + 1
    m = torch.full((B, KVH, SG), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, KVH, SG), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, KVH, SG, d), dtype=torch.float32, device=q.device)
    offs = torch.arange(bs, device=q.device)
    for j in range(n_live):
        blk = block_tables[:, j].long()
        kb = k_pool[blk].float()                       # (B, bs, KVH, d)
        vb = v_pool[blk].float()
        s = torch.einsum("bkrd,btkd->bkrt", qf, kb) * scale
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        k_pos = j * bs + offs
        mask = k_pos[None, None, :] <= qpos[:, :, None]           # (B,SG,bs)
        if window > 0:
            mask &= (qpos[:, :, None] - k_pos[None, None, :]) < window
        mask = mask[:, None]
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkrt,btkd->bkrd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def paged_prefill_gqa(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      starts: torch.Tensor, *, groups: int, window: int = 0,
                      softcap: float = 0.0) -> torch.Tensor:
    """K2: q (B, KVH, S*G, d) packed span queries; k/v pools
    (nb, bs, KVH, d); tables (B, mb) int32; starts (B,) int32 ->
    (B, KVH, S*G, d) in q.dtype."""
    if q.device.type == "cpu":
        return paged_prefill_gqa_plain(q, k_pool, v_pool, block_tables,
                                       starts, groups=groups, window=window,
                                       softcap=softcap)
    check_cuda_args(q, k_pool, v_pool, block_tables, starts)
    B, KVH, SG, d = q.shape
    if SG % groups:
        raise ValueError(f"packed rows {SG} not a multiple of groups {groups}")
    out = torch.empty_like(q)
    err = cuda_entry("paged_prefill_gqa")(
        _DTYPE_CODE[q.dtype], d, k_pool.shape[1], q.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
        starts.data_ptr(), out.data_ptr(), B, KVH, SG, groups,
        block_tables.shape[1], window, softcap, d ** -0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged_prefill_gqa launch failed: cudaError {err}")
    paged_prefill_gqa.launches += 1
    return out


paged_prefill_gqa.launches = 0
