"""Gather-path oracles for the paged GQA, MLA and DSA-indexer kernels (port
of the reference's ``kernels/paged_attention/ref.py``).

Materialize the padded per-sequence view with ``paged_view``, then run the
dense / absorbed attention or indexer math over it; view index == absolute
position, so the plain causal mask by position is exact.  ``impl="ref"``
selects this path explicitly, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.paging import paged_view
from repro_torch.layers.attention import NEG_INF, dense_attention


def paged_gqa_reference(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        seq_lens: torch.Tensor, *, window: int = 0,
                        softcap: float = 0.0) -> torch.Tensor:
    """q (B, 1, H, d) -> (B, 1, H, d): gather the view, dense-attend."""
    B = q.shape[0]
    k_full = paged_view(k_pool, block_tables)
    v_full = paged_view(v_pool, block_tables)
    T = k_full.shape[1]
    kv_positions = torch.arange(T, device=q.device).expand(B, T)
    return dense_attention(q, k_full, v_full, seq_lens.long()[:, None],
                           kv_positions, causal=True, window=window,
                           softcap=softcap)


def paged_gqa_prefill_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                starts: torch.Tensor, *, window: int = 0,
                                softcap: float = 0.0) -> torch.Tensor:
    """Span prefill over the gathered view: q (B, S, H, d), starts (B,)
    -> (B, S, H, d).  Query i of row b sits at position starts[b] + i."""
    B, S = q.shape[:2]
    k_full = paged_view(k_pool, block_tables)
    v_full = paged_view(v_pool, block_tables)
    T = k_full.shape[1]
    kv_positions = torch.arange(T, device=q.device).expand(B, T)
    q_positions = starts.long()[:, None] + torch.arange(S, device=q.device)
    return dense_attention(q, k_full, v_full, q_positions, kv_positions,
                           causal=True, window=window, softcap=softcap)


def absorbed_probs_c(q_lat, q_rope, c_view, kr_view, mask, scale):
    """The absorbed-MLA attention term shared with ``core/mla.py``:
    softmax((q_lat·c + q_rope·kr)·scale, masked) · c, all in fp32:
    q (B, S, H, ·), views (B, T, ·), mask (B, S, T) -> (B, S, H, lora)."""
    cf = c_view.float()
    scores = (torch.einsum("bshl,btl->bsht", q_lat.float(), cf)
              + torch.einsum("bshr,btr->bsht", q_rope.float(),
                             kr_view.float())) * scale
    scores = torch.where(mask[:, :, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bsht,btl->bshl", probs, cf)


def paged_mla_reference(q_lat: torch.Tensor, q_rope: torch.Tensor,
                        c_pool: torch.Tensor, kr_pool: torch.Tensor,
                        block_tables: torch.Tensor, seq_lens: torch.Tensor,
                        *, scale: float) -> torch.Tensor:
    """Absorbed MQA scores/PV over the gathered latent view.

    q_lat (B, 1, H, lora); q_rope (B, 1, H, rope) -> out_lat
    (B, 1, H, lora) fp32 — the ``probs · c`` term of
    ``repro_torch.core.mla._absorbed_attend``."""
    c_view = paged_view(c_pool, block_tables)            # (B, T, lora)
    kr_view = paged_view(kr_pool, block_tables)
    T = c_view.shape[1]
    kv_pos = torch.arange(T, device=q_lat.device)
    mask = kv_pos[None, None, :] <= seq_lens.long()[:, None, None]
    return absorbed_probs_c(q_lat, q_rope, c_view, kr_view, mask, scale)


def paged_indexer_reference(q_idx: torch.Tensor, w_head: torch.Tensor,
                            k_pool: torch.Tensor, block_tables: torch.Tensor,
                            seq_lens: torch.Tensor) -> torch.Tensor:
    """DSA indexer scores over the gathered k_idx view: q_idx (B, Hi, Di),
    w_head (B, Hi), k_pool (nb, bs, Di) -> (B, mb*bs) fp32, relu(q·k)·Di^-½
    summed over heads with the weights.  ``seq_lens`` is unused (the
    selector masks every position past the query) but kept for signature
    parity with the in-place path."""
    del seq_lens
    k_view = paged_view(k_pool, block_tables).float()   # (B, T, Di)
    dots = torch.einsum("bhd,btd->bht", q_idx.float(), k_view)
    dots = torch.relu(dots) * (q_idx.shape[-1] ** -0.5)
    return torch.einsum("bht,bh->bt", dots, w_head.float())


def paged_indexer_prefill_reference(q_idx: torch.Tensor,
                                    w_head: torch.Tensor,
                                    k_pool: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    starts: torch.Tensor) -> torch.Tensor:
    """Span indexer scores over the gathered k_idx view: q_idx (B, S, Hi,
    Di), w_head (B, S, Hi) -> (B, S, mb*bs) fp32.  ``starts`` is unused,
    as ``seq_lens`` above."""
    del starts
    k_view = paged_view(k_pool, block_tables).float()
    dots = torch.einsum("bshd,btd->bsht", q_idx.float(), k_view)
    dots = torch.relu(dots) * (q_idx.shape[-1] ** -0.5)
    return torch.einsum("bsht,bsh->bst", dots, w_head.float())


def paged_mla_prefill_reference(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                c_pool: torch.Tensor, kr_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                starts: torch.Tensor, *,
                                scale: float) -> torch.Tensor:
    """Absorbed MQA span scores/PV over the gathered latent view.

    q_lat (B, S, H, lora); q_rope (B, S, H, rope); starts (B,) -> out_lat
    (B, S, H, lora) fp32, under the span's causal mask (query i of row b
    sits at position ``starts[b] + i``)."""
    S = q_lat.shape[1]
    c_view = paged_view(c_pool, block_tables)
    kr_view = paged_view(kr_pool, block_tables)
    T = c_view.shape[1]
    kv_pos = torch.arange(T, device=q_lat.device)
    q_pos = starts.long()[:, None] + torch.arange(S, device=q_lat.device)
    mask = kv_pos[None, None, :] <= q_pos[:, :, None]   # (B, S, T)
    return absorbed_probs_c(q_lat, q_rope, c_view, kr_view, mask, scale)
