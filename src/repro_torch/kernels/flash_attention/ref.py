"""Plain PyTorch K9: the function the flash-attention kernel computes.

Port of ``repro.kernels.flash_attention.ref.reference`` in the model's
layout, q (B, Sq, H, d) and k/v (B, Sk, KVH, d), with query head ``h``
reading KV head ``h // G``.  Query ``i`` sits at position ``q_offset + i``,
key ``j`` at ``j``; scores are scaled by d^-1/2 and soft-capped before the
causal / window mask; the softmax is exact in fp32, with masked entries at
p = 0 and the normaliser clamped at 1e-20 as the Pallas kernel does, so a
query that sees no key gets 0 (the reference's ``ref.py`` would average
every key there; the model never asks for such a row).  Queries are taken
``Q_CHUNK`` rows at a time, which bounds the (B, KVH, G, rows, Sk) fp32
scores and changes no value.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
Q_CHUNK = 1024


def reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0, softcap: float = 0.0,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, d), k/v (B, Sk, KVH, d) -> (B, Sq, H, d) in q.dtype."""
    B, Sq, H, d = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    kf, vf = k.float(), v.float()
    kp = torch.arange(Sk, device=q.device)
    out = torch.empty_like(q)
    for lo in range(0, Sq, Q_CHUNK):
        hi = min(lo + Q_CHUNK, Sq)
        qc = q[:, lo:hi].float().reshape(B, hi - lo, KVH, G, d)
        s = torch.einsum("bskgd,btkd->bkgst", qc, kf) * d ** -0.5
        if softcap > 0:
            s = softcap * torch.tanh(s / softcap)
        qp = q_offset + torch.arange(lo, hi, device=q.device)[:, None]
        mask = torch.ones((hi - lo, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kp[None] <= qp
        if window > 0:
            mask &= (qp - kp[None]) < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = torch.einsum("bkgst,btkd->bskgd", p, vf)
        l = p.sum(-1).clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
        out[:, lo:hi] = (o / l).reshape(B, hi - lo, H, d).to(q.dtype)
    return out
