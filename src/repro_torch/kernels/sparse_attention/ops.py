"""The Pallas kernel's entry point in the model's layout (port of
``repro.kernels.sparse_attention.ops``).

``sparse_attend`` takes block ids shared by the heads of a batch row, as
the reference's does, de-duplicates them (a repeated id would count its
block twice) and runs K8 with queries from position 0 and the Pallas
kernel's rule for a query that sees no key (0).  The reference repeats K/V
G times and folds (B, H) into one axis for its kernel; K8 reads the
model's layout as it is.  The model reaches K8 through
``core.dsa.sparse_block_attention`` instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sparse_attention import kernel


def dedupe_blocks(bidx: torch.Tensor) -> torch.Tensor:
    """Map repeated ids within each row to -1 (keep the first occurrence)."""
    nb = bidx.shape[-1]
    eq = bidx[..., :, None] == bidx[..., None, :]             # (..., nb, nb)
    earlier = torch.ones((nb, nb), dtype=torch.bool,
                         device=bidx.device).tril(-1)
    dup = (eq & earlier).any(-1)
    return torch.where(dup, torch.full_like(bidx, -1), bidx)


def sparse_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  block_idx: torch.Tensor, *, block_size: int = 128,
                  softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, T, KVH, d), block_idx (B, S//bs, nb) shared
    by the heads (-1 = skip) -> (B, S, H, d)."""
    bidx = dedupe_blocks(block_idx.to(torch.int32)).contiguous()
    start = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    return kernel.block_sparse_attention(
        q.contiguous(), k.contiguous(), v.contiguous(), bidx, start,
        block_size=block_size, softcap=softcap)
