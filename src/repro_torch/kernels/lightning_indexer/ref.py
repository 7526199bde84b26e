"""Plain PyTorch K7: the function the lightning-indexer kernel computes.

Port of ``repro.kernels.lightning_indexer.ref.reference`` (the reference
model's XLA ``indexer_scores`` in the kernel's layout):
``I[b,s,t] = Σ_h w[b,s,h]·ReLU(q[b,s,h]·k[b,t])·Di^-1/2`` in fp32, every
(s, t) given (the causal mask is the caller's).
"""
from __future__ import annotations

import torch


def reference(q_idx: torch.Tensor, w_head: torch.Tensor, k_idx: torch.Tensor,
              *, heads: int, head_dim: int) -> torch.Tensor:
    """q_idx (B, S, Hi*Di), w_head (B, S, Hi), k_idx (B, T, Di) -> (B, S, T)
    fp32."""
    B, S, _ = q_idx.shape
    q = q_idx.reshape(B, S, heads, head_dim).float()
    dots = torch.einsum("bshd,btd->bsht", q, k_idx.float())
    dots = torch.relu(dots) * head_dim ** -0.5
    return torch.einsum("bsht,bsh->bst", dots, w_head.float())
