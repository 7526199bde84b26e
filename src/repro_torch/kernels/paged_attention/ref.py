"""Gather-path oracle for the paged GQA kernels (port of the reference's
``kernels/paged_attention/ref.py``, GQA part).

Materialize the padded per-sequence view with ``paged_view``, then run the
dense attention math over it; view index == absolute position, so the plain
causal mask by position is exact.  ``impl="ref"`` selects this path
explicitly, on any device.
"""
from __future__ import annotations

import torch

from repro_torch.core.paging import paged_view
from repro_torch.layers.attention import dense_attention


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
