"""Oracle of the Pallas block-sparse kernel: dense attention restricted to
the selected key blocks.

Port of ``repro.kernels.sparse_attention.ref.reference``, in the Pallas
kernel's layout: q (BH, S, d), k/v (BH, T, d), block_idx (BH, S/bs, nb)
int32 with -1 = skip.  Query ``i`` sits at position ``i``, key ``j`` at
``j``; a query attends the keys of its query block's selected blocks at or
before its position; the softmax is exact in fp32 and a query that sees no
key gets 0.  The model's form of the function is ``kernel.py``'s plain
version.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              block_idx: torch.Tensor, *, block_size: int = 128,
              softcap: float = 0.0) -> torch.Tensor:
    """Same contract as the Pallas ``block_sparse_attention``."""
    BH, S, d = q.shape
    T = k.shape[1]
    nqb, nkb = S // block_size, T // block_size
    allowed = torch.zeros((BH, nqb, nkb), dtype=torch.bool, device=q.device)
    ids = block_idx.long()
    # a -1 entry clipped to block 0 must not unset a selected block 0
    allowed.scatter_reduce_(2, ids.clamp(0, nkb - 1), ids >= 0, "amax")
    tok = allowed.repeat_interleave(block_size, 1) \
        .repeat_interleave(block_size, 2)                 # (BH, S, T)
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    causal = torch.arange(T, device=q.device)[None, :] \
        <= torch.arange(S, device=q.device)[:, None]
    ok = tok & causal[None]
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
    p = torch.where(ok, p, 0.0)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
