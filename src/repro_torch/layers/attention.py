"""Dense attention substrate: GQA with RoPE, sliding window, logit softcap.

Port of ``repro.layers.attention``.  ``dense_attention`` is the exact
reference math (fp32 scores and softmax); the contiguous-cache oracle and
the ``ref`` paged gather path both run it.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import _empty, apply_rope, rmsnorm

NEG_INF = -2.0e38


def attention_mask(q_positions: torch.Tensor, kv_positions: torch.Tensor,
                   *, causal: bool = True, window: int = 0,
                   kv_len=None) -> torch.Tensor:
    """(..., S, T) boolean mask. window>0 = sliding-window (local) layers."""
    qp = q_positions[..., :, None]
    kp = kv_positions[..., None, :]
    m = torch.ones(torch.broadcast_shapes(qp.shape, kp.shape),
                   dtype=torch.bool, device=qp.device)
    if causal:
        m &= kp <= qp
    if window > 0:
        m &= (qp - kp) < window
    if kv_len is not None:
        m &= kp < kv_len
    return m


def _scores_to_probs(scores: torch.Tensor, mask: torch.Tensor,
                     softcap: float) -> torch.Tensor:
    scores = scores.float()
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    return torch.softmax(scores, dim=-1)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_positions: torch.Tensor, kv_positions: torch.Tensor,
                    *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, kv_len=None) -> torch.Tensor:
    """q (B,S,H,dh), k (B,T,KVH,dh), v (B,T,KVH,dv) -> (B,S,H,dv)."""
    B, S, H, dh = q.shape
    KVH = k.shape[2]
    dv = v.shape[-1]
    G = H // KVH
    scale = dh ** -0.5
    qg = q.reshape(B, S, KVH, G, dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = attention_mask(q_positions, kv_positions, causal=causal,
                          window=window, kv_len=kv_len)
    probs = _scores_to_probs(scores, mask[:, None, None], softcap)
    out = torch.einsum("bkgst,btkv->bskgv", probs.to(v.dtype), v)
    return out.reshape(B, S, H, dv)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Projection weights of one GQA attention layer, (in, out) layout."""

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        D, H, KVH, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                         cfg.head_dim)
        kw = dict(device=device, dtype=dtype)
        self.wq = _empty(D, H * dh, **kw)
        self.wk = _empty(D, KVH * dh, **kw)
        self.wv = _empty(D, KVH * dh, **kw)
        self.wo = _empty(H * dh, D, **kw)
        if cfg.qk_norm:
            self.q_norm = _empty(dh, **kw)
            self.k_norm = _empty(dh, **kw)


def gqa_qkv(params: GQA, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    H, KVH, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ params.wq).reshape(B, S, H, dh)
    k = (x @ params.wk).reshape(B, S, KVH, dh)
    v = (x @ params.wv).reshape(B, S, KVH, dh)
    if cfg.qk_norm:
        q = rmsnorm(q, params.q_norm, cfg.norm_eps)
        k = rmsnorm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_base)
    k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v
