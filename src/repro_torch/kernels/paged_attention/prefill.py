"""K2, K4 and K6: paged span kernels, hand-written for Hopper, and their
plain versions.

K2 ``paged_prefill_gqa`` ports ``repro.kernels.paged_attention.prefill.
paged_prefill_gqa`` (GQA); K4 ``paged_prefill_mla`` ports
``paged_prefill_mla`` (absorbed MLA over the latent pools); K6
``paged_prefill_indexer`` ports ``paged_prefill_indexer`` (DSA
lightning-indexer span scores over the ``k_idx`` pool).  A span is S
consecutive tokens of one sequence; query ``i`` of row ``b`` sits at
absolute position ``starts[b] + i`` and its K/V were scattered through the
table before the call.  Attention is causal by absolute position: full
attention to the cached prefix, causal within the span (K2 optionally
windowed and soft-capped).

Queries come packed as in the reference: K2 takes (B, KVH, S*G, d), row
``i*G + g`` is group query ``g`` of span token ``i``; K4 takes (B, S*H, ·)
and K6 (B, S*Hi, Di), row ``i*H + h`` is head ``h`` of span token ``i``.
The CUDA kernels (``csrc/paged_attention.cu``, ``csrc/paged_mla.cu``,
``csrc/paged_indexer.cu``) tile those rows — the Pallas kernels keep the
whole span resident in VMEM, which no Hopper shared memory holds — and each
attention tile stops at the block of its own last query position; K6 scores
every block up to the span's last position.  K2 and K4 choose their body by
dtype: bf16 (the serving path) runs a tensor-core tile (mma.sync, K/V in a
cp.async ring, each tile's causal key range split over up to 4 CTAs with a
combine pass when that fills the card better: K2 the tile of
``csrc/mma_tile.cuh``, K4 its 16-warp MLA form in ``csrc/paged_mla.cu``);
fp32 runs the exact SIMT bodies (``csrc/gqa_tile.cuh``, K4's own).  K6 in
bf16 at 8, 16 or 32 indexer heads runs a tensor-core body of its own
(``span_mma``: the keys as mma.sync's A operand, the heads of a token as
its N, ReLU and the weighted head sum on the accumulator); fp32 and other
head counts run the SIMT tile it shares with K5 and K7.

Each wrapper runs the plain version on CPU and meta tensors and launches the kernel
on CUDA tensors, or raises; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import count_launch, key_split, refuse_dtensor
from repro_torch.kernels.paged_attention.kernel import (
    NEG_INF, _DTYPE_CODE, _check_launch, check_cuda_args,
    check_cuda_indexer_args, check_cuda_mla_args, cuda_entry,
    indexer_fold_blocks, mla_fold_blocks)


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
    (B, KVH, S*G, d) in q.dtype.

    On CUDA tensors bf16 launches the tensor-core tile (and, when its key
    range is split, its combine pass: one launch counted), fp32 the SIMT
    tile."""
    refuse_dtensor("paged_prefill_gqa", q, k_pool, v_pool, block_tables,
                   starts)
    if q.device.type in ("cpu", "meta"):
        return paged_prefill_gqa_plain(q, k_pool, v_pool, block_tables,
                                       starts, groups=groups, window=window,
                                       softcap=softcap)
    check_cuda_args(q, k_pool, v_pool, block_tables, starts)
    B, KVH, SG, d = q.shape
    if SG % groups:
        raise ValueError(f"packed rows {SG} not a multiple of groups {groups}")
    bs = k_pool.shape[1]
    out = torch.empty_like(q)
    parts, ws = 1, None
    if q.dtype == torch.bfloat16:
        parts, ws = key_split("paged_prefill_gqa_resources", (d, bs), SG,
                              KVH * B, d, q.device)
    err = cuda_entry("paged_prefill_gqa")(
        _DTYPE_CODE[q.dtype], d, bs, q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, KVH, SG, groups, block_tables.shape[1], window,
        softcap, d ** -0.5, parts, None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q.device).cuda_stream)
    _check_launch("paged_prefill_gqa", err)
    count_launch(paged_prefill_gqa)
    return out


paged_prefill_gqa.launches = 0


# ---------------------------------------------------------------------------
# K4: absorbed MLA span prefill over the latent pools
# ---------------------------------------------------------------------------

def _span_rows(q_lat: torch.Tensor, heads: int) -> int:
    SH = q_lat.shape[1]
    if SH % heads:
        raise ValueError(f"packed rows {SH} not a multiple of heads {heads}")
    return SH // heads


def paged_prefill_mla_plain(q_lat: torch.Tensor, q_rope: torch.Tensor,
                            c_pool: torch.Tensor, kr_pool: torch.Tensor,
                            block_tables: torch.Tensor, starts: torch.Tensor,
                            *, heads: int, scale: float) -> torch.Tensor:
    """Plain PyTorch K4 (counterpart of the reference's
    ``ops._blocked_mla_prefill``): q_lat (B, S*H, lora) packed -> (B, S*H,
    lora) fp32, folding blocks up to the batch's last span position."""
    S = _span_rows(q_lat, heads)
    st = starts.long()
    q_pos = st[:, None] + torch.arange(q_lat.shape[1],
                                       device=q_lat.device)[None] // heads
    n_live = (int(st.max()) + S - 1) // c_pool.shape[1] + 1
    return mla_fold_blocks(q_lat, q_rope, c_pool, kr_pool, block_tables,
                           q_pos, n_live, scale)


def paged_prefill_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_pool: torch.Tensor, kr_pool: torch.Tensor,
                      block_tables: torch.Tensor, starts: torch.Tensor, *,
                      heads: int, scale: float) -> torch.Tensor:
    """K4: q_lat (B, S*H, lora) fp32 packed (row i*H + h = head h of span
    token i); q_rope (B, S*H, rope); c/kr pools (nb, bs, ·); tables (B, mb)
    int32; starts (B,) int32 -> out_lat (B, S*H, lora) fp32 (``probs · c``;
    the caller applies W^UV and W^O).

    On CUDA tensors bf16 pools launch the tensor-core tile (q_lat rounded
    to bf16 as it is staged, P rounded to bf16 for PV; with its key range
    split, its combine pass too: one launch counted), fp32 pools the SIMT
    body."""
    refuse_dtensor("paged_prefill_mla", q_lat, q_rope, c_pool, kr_pool,
                   block_tables, starts)
    if q_lat.device.type in ("cpu", "meta"):
        return paged_prefill_mla_plain(q_lat, q_rope, c_pool, kr_pool,
                                       block_tables, starts, heads=heads,
                                       scale=scale)
    check_cuda_mla_args(q_lat, q_rope, c_pool, kr_pool, block_tables, starts)
    _span_rows(q_lat, heads)
    B, SH, L = q_lat.shape
    R = q_rope.shape[-1]
    out = torch.empty_like(q_lat)
    parts, ws = 1, None
    if c_pool.dtype == torch.bfloat16:
        parts, ws = key_split("paged_mla_resources", (1, L, R), SH, B, L,
                              q_lat.device)
    err = cuda_entry("paged_prefill_mla")(
        _DTYPE_CODE[c_pool.dtype], L, R, c_pool.shape[1],
        q_lat.data_ptr(), q_rope.data_ptr(), c_pool.data_ptr(),
        kr_pool.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, SH, heads, block_tables.shape[1], scale, parts,
        None if ws is None else ws.data_ptr(),
        torch.cuda.current_stream(q_lat.device).cuda_stream)
    _check_launch("paged_prefill_mla", err)
    count_launch(paged_prefill_mla)
    return out


paged_prefill_mla.launches = 0


# ---------------------------------------------------------------------------
# K6: DSA lightning-indexer span scores over the k_idx pool
# ---------------------------------------------------------------------------

def paged_prefill_indexer_plain(q_idx: torch.Tensor, w_head: torch.Tensor,
                                k_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                starts: torch.Tensor, *,
                                heads: int) -> torch.Tensor:
    """Plain PyTorch K6 (counterpart of the reference's
    ``ops._blocked_indexer_prefill``, with the kernel's per-row dead
    blocks): q_idx (B, S*Hi, Di) packed; w_head (B, S*Hi) -> (B, S, mb*bs)
    fp32."""
    S = _span_rows(q_idx, heads)
    B, _, Di = q_idx.shape
    return indexer_fold_blocks(q_idx.reshape(B, S, heads, Di),
                               w_head.reshape(B, S, heads), k_pool,
                               block_tables, starts.long() + S - 1)


def paged_prefill_indexer(q_idx: torch.Tensor, w_head: torch.Tensor,
                          k_pool: torch.Tensor, block_tables: torch.Tensor,
                          starts: torch.Tensor, *, heads: int) -> torch.Tensor:
    """K6: q_idx (B, S*Hi, Di) packed (row i*Hi + h = indexer head h of span
    token i) in the pool's dtype; w_head (B, S*Hi) fp32; k_pool
    (nb, bs, Di); tables (B, mb) int32; starts (B,) int32 -> scores
    (B, S, mb*bs) fp32 in view coordinates; blocks past the span's last
    position are NEG_INF."""
    refuse_dtensor("paged_prefill_indexer", q_idx, w_head, k_pool,
                   block_tables, starts)
    if q_idx.device.type in ("cpu", "meta"):
        return paged_prefill_indexer_plain(q_idx, w_head, k_pool,
                                           block_tables, starts, heads=heads)
    check_cuda_indexer_args(q_idx, w_head, k_pool, block_tables, starts,
                            heads)
    S = _span_rows(q_idx, heads)
    B, SH, Di = q_idx.shape
    bs, mb = k_pool.shape[1], block_tables.shape[1]
    out = torch.empty((B, S, mb * bs), dtype=torch.float32,
                      device=q_idx.device)
    err = cuda_entry("paged_prefill_indexer")(
        _DTYPE_CODE[q_idx.dtype], Di, bs, q_idx.data_ptr(), w_head.data_ptr(),
        k_pool.data_ptr(), block_tables.data_ptr(), starts.data_ptr(),
        out.data_ptr(), B, SH, heads, mb, Di ** -0.5,
        torch.cuda.current_stream(q_idx.device).cuda_stream)
    _check_launch("paged_prefill_indexer", err)
    count_launch(paged_prefill_indexer)
    return out


paged_prefill_indexer.launches = 0
