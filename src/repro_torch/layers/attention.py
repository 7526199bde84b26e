"""Dense attention substrate: GQA with RoPE, sliding window, logit softcap.

Port of ``repro.layers.attention``.  ``dense_attention`` is the exact
reference math (fp32 scores and softmax); the contiguous-cache oracle and
the ``ref`` paged gather path both run it.  Without a cache (training, and
full-sequence logits) the GQA layer runs ``flash_attend``: K9
(``kernels.flash_attention``) forward, causal or not and with Sk != Sq,
and a plain backward that recomputes ``dense_attention`` with the same
mask a query chunk at a time — the reference runs ``dense_attention``
there, query-chunked under ``jax.checkpoint``.  ``apply_gqa`` is the
reference's one-layer entry of the encoder-decoder (``models.encdec``):
self-attention without a cache (K9, causal), with a contiguous cache
(``dense_attention``), and cross-attention over given K/V (K9, not
causal).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.layers.common import _empty, apply_rope, rmsnorm
from repro_torch.sharding.rules import (batch_placements, constrain_batch,
                                        is_placed, local_apply, mesh_axes,
                                        split_dim)

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
    qg = split_dim(q, 2, (KVH, G))
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = attention_mask(q_positions, kv_positions, causal=causal,
                          window=window, kv_len=kv_len)
    if is_placed(scores):              # the reference's constraints
        scores = constrain_batch(scores, scores.device_mesh)
    probs = _scores_to_probs(scores, mask[:, None, None], softcap)
    out = torch.einsum("bkgst,btkv->bskgv", probs.to(v.dtype), v)
    out = out.reshape(B, S, H, dv)
    return constrain_batch(out, out.device_mesh) if is_placed(out) else out


class _FlashAttend(torch.autograd.Function):
    """K9 forward; the backward recomputes ``dense_attention`` with the
    same mask over ``q_chunk`` query rows at a time and differentiates it
    (the gradient of the function the reference computes with XLA)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        ctx.softcap, ctx.q_chunk = softcap, q_chunk
        return flash_ops.attend(q, k, v, causal=causal, window=window,
                                softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        B, S = q.shape[:2]
        T = k.shape[1]
        qpos = torch.arange(S, device=q.device).expand(B, S)
        kpos = torch.arange(T, device=q.device).expand(B, T)
        dq = torch.empty_like(q)
        dk = torch.zeros_like(k)
        dv = torch.zeros_like(v)
        step = ctx.q_chunk if ctx.q_chunk > 0 else S
        kd, vd = k.detach().requires_grad_(), v.detach().requires_grad_()
        for lo in range(0, S, step):
            hi = min(lo + step, S)
            with torch.enable_grad():
                qc = q[:, lo:hi].detach().requires_grad_()
                out = dense_attention(qc, kd, vd, qpos[:, lo:hi], kpos,
                                      causal=ctx.causal, window=ctx.window,
                                      softcap=ctx.softcap)
                gq, gk, gv = torch.autograd.grad(out, (qc, kd, vd),
                                                 g[:, lo:hi])
            dq[:, lo:hi] = gq
            dk += gk
            dv += gv
        return dq, dk, dv, None, None, None, None


def flash_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = True, window: int = 0, softcap: float = 0.0,
                 q_chunk: int = 1024) -> torch.Tensor:
    """Attention with no cache, differentiable: q (B, Sq, H, dh), k/v (B,
    Sk, KVH, dh) -> (B, Sq, H, dh), query i at position i and key j at j.
    ``causal`` masks keys past a query's position (self-attention, Sq =
    Sk); without it every key is seen (an encoder's self-attention,
    cross-attention with Sq != Sk).

    Placed (``DTensor``) inputs run K9 on each rank's local tensors: the
    batch over ('pod', 'data') and the heads over 'model' where both the
    query and the key/value heads divide over it (the reference's
    ``constrain_batch`` of the output); where they do not, q, k and v are
    gathered over 'model' first and every 'model' rank attends all heads.
    K9 reads every key of a row, so a key length the rules shard (the
    reference's ``kv_seq`` over 'data' under ``context_parallel_kv``) is
    gathered by that redistribution first.
    """
    def attend(q, k, v):
        return _FlashAttend.apply(q, k, v, causal, window, softcap, q_chunk)

    if not is_placed(q, k, v):
        return attend(q, k, v)
    mesh = q.device_mesh
    model = mesh_axes(mesh).get("model", 1)
    heads = q.shape[2] if k.shape[2] % model == 0 else 1
    pl = batch_placements(mesh, q.shape[0], model_dim=2, size=heads)
    return local_apply(attend, (q, k, v), (pl, pl, pl), pl)


# ---------------------------------------------------------------------------
# GQA layer
# ---------------------------------------------------------------------------

class GQA(nn.Module):
    """Projection weights of one GQA attention layer, (in, out) layout."""

    AXES = {"wq": ("embed_fsdp", "heads"), "wk": ("embed_fsdp", "kv_heads"),
            "wv": ("embed_fsdp", "kv_heads"), "wo": ("heads", "embed_fsdp"),
            "q_norm": ("embed",), "k_norm": ("embed",)}

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
    q = split_dim(x @ params.wq, 2, (H, dh))
    k = split_dim(x @ params.wk, 2, (KVH, dh))
    v = split_dim(x @ params.wv, 2, (KVH, dh))
    if cfg.qk_norm:
        q = rmsnorm(q, params.q_norm, cfg.norm_eps)
        k = rmsnorm(k, params.k_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_base)
    k = apply_rope(k, positions, cfg.rope_base)
    return q, k, v


def apply_gqa(params: GQA, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              cache_index: Optional[int] = None,
              cross_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[dict]]:
    """One global attention layer (the reference's ``apply_gqa``); returns
    (out, cache).

    ``cross_kv`` (k, v) (B, T, KVH, dh) switches to cross-attention: q is
    ``x @ wq`` with no RoPE and no q_norm, every key is seen, and the cache
    is returned as given (K9, not causal).  Otherwise q, k and v come from
    ``gqa_qkv``: without a cache causal self-attention over positions
    0..S-1 (K9); with a contiguous cache {"k", "v"} (B, T, KVH, dh) the S
    new keys are written at ``cache_index`` in place and the queries
    attend the first ``cache_index + S`` of them (``dense_attention``)."""
    B, S, _ = x.shape
    if cross_kv is not None:
        q = split_dim(x @ params.wq, 2, (cfg.num_heads, cfg.head_dim))
        k, v = cross_kv
        out = flash_attend(q, k, v, causal=False, q_chunk=cfg.q_chunk)
        return out.reshape(B, S, -1) @ params.wo, cache
    q, k, v = gqa_qkv(params, x, cfg, positions)
    if cache is None:
        out = flash_attend(q, k, v, softcap=cfg.attn_logit_softcap,
                           q_chunk=cfg.q_chunk)
        return out.reshape(B, S, -1) @ params.wo, None
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, cache_index:cache_index + S] = k.to(k_cache.dtype)
    v_cache[:, cache_index:cache_index + S] = v.to(v_cache.dtype)
    T = k_cache.shape[1]
    kv_positions = torch.arange(T, device=x.device).expand(B, T)
    out = dense_attention(q, k_cache, v_cache, positions, kv_positions,
                          causal=True, softcap=cfg.attn_logit_softcap,
                          kv_len=cache_index + S)
    return out.reshape(B, S, -1) @ params.wo, cache
