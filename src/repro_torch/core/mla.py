"""Multi-latent attention (MLA) with the GLM-5 MLA-256 geometry.

Port of ``repro.core.mla``.  Without a cache it runs MHA-style (the latent
expanded to per-head K/V, ``apply_mla``); with a cache it runs the
*absorbed* MQA-style path over the compressed latent cache (kv_lora_dim +
qk_rope_dim values per token, 512 + 64 = 576 for GLM-5), which is the
memory saving MLA exists for: ``mla_decode_absorbed`` over the contiguous
cache of the static oracle, ``mla_decode_paged`` over the paged pools of
the continuous engine, where single-token steps read the pool in place
through K3 and spans through K4.

Weights keep the reference's (in, out) layout and names (``build_mla``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paging import paged_update, paged_view
from repro_torch.kernels.paged_attention.ops import (paged_mla_attend,
                                                     paged_mla_prefill)
from repro_torch.kernels.paged_attention.ref import absorbed_probs_c
from repro_torch.layers.attention import attention_mask, dense_attention
from repro_torch.layers.common import _empty, apply_rope, rmsnorm
from repro_torch.sharding.rules import split_dim


class MLA(nn.Module):
    """Projection weights of one MLA layer (the reference's ``build_mla``)."""

    AXES = {"wq_a": ("embed_fsdp", "lora"), "q_a_norm": ("embed",),
            "wq_b": ("lora", "heads"), "wkv_a": ("embed_fsdp", None),
            "kv_a_norm": ("embed",), "wkv_b": ("lora", "heads"),
            "wo": ("heads", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        m = cfg.mla
        D, H = cfg.d_model, cfg.num_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        kw = dict(device=device, dtype=dtype)
        self.wq_a = _empty(D, m.q_lora_dim, **kw)
        self.q_a_norm = _empty(m.q_lora_dim, **kw)
        self.wq_b = _empty(m.q_lora_dim, H * qk, **kw)
        self.wkv_a = _empty(D, m.kv_lora_dim + m.qk_rope_dim, **kw)
        self.kv_a_norm = _empty(m.kv_lora_dim, **kw)
        self.wkv_b = _empty(m.kv_lora_dim, H * (m.qk_nope_dim + m.v_head_dim),
                            **kw)
        self.wo = _empty(H * m.v_head_dim, D, **kw)


def _scale(cfg: ModelConfig) -> float:
    """Score scale (qk_nope + qk_rope)^-1/2: the query/key head dim, not
    the absorbed (kv_lora + rope) dot length."""
    return (cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5


def mla_qkv(params: MLA, x: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor):
    """Returns (q (B,S,H,qk), k (B,S,H,qk), v (B,S,H,dv), c, k_rope).

    c (B,S,kv_lora) and k_rope (B,S,rope) are what decode caches."""
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    q_nope, q_rope, c, k_rope = _absorbed_q_and_latents(params, x, cfg,
                                                        positions)
    kv = split_dim(c @ params.wkv_b, 2, (H, m.qk_nope_dim + m.v_head_dim))
    k_nope, v = kv.split([m.qk_nope_dim, m.v_head_dim], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H,
                                                        m.qk_rope_dim)],
                  dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, c, k_rope


def apply_mla(params: MLA, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor) -> torch.Tensor:
    """MHA-style forward without a cache (train / full-sequence logits)."""
    B, S, _ = x.shape
    q, k, v, _, _ = mla_qkv(params, x, cfg, positions)
    out = dense_attention(q, k, v, positions, positions, causal=True)
    return out.reshape(B, S, -1) @ params.wo


def _wkv_b_split(params: MLA, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """W^UK (kv_lora, H, nope) and W^UV (kv_lora, H, dv) views of wkv_b."""
    m = cfg.mla
    w = split_dim(params.wkv_b, 1, (cfg.num_heads,
                                    m.qk_nope_dim + m.v_head_dim))
    return w[..., :m.qk_nope_dim], w[..., m.qk_nope_dim:]


def _absorbed_q_and_latents(params: MLA, x: torch.Tensor, cfg: ModelConfig,
                            positions: torch.Tensor):
    """Projections shared by both absorbed-decode cache layouts.

    Returns (q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_new (B,S,kv_lora),
    kr_new (B,S,rope)), RoPE applied to both rope parts."""
    m = cfg.mla
    B, S, _ = x.shape
    qa = rmsnorm(x @ params.wq_a, params.q_a_norm, cfg.norm_eps)
    q = split_dim(qa @ params.wq_b, 2, (cfg.num_heads,
                                        m.qk_nope_dim + m.qk_rope_dim))
    q_nope, q_rope = q.split([m.qk_nope_dim, m.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_base)
    c_new, kr_new = (x @ params.wkv_a).split([m.kv_lora_dim, m.qk_rope_dim],
                                             dim=-1)
    c_new = rmsnorm(c_new, params.kv_a_norm, cfg.norm_eps)
    kr_new = apply_rope(kr_new[:, :, None, :], positions,
                        cfg.rope_base)[:, :, 0, :]
    return q_nope, q_rope, c_new, kr_new


def _absorb_query(params: MLA, cfg: ModelConfig,
                  q_nope: torch.Tensor) -> torch.Tensor:
    """q_lat = q_nope · W^UK in fp32: (B,S,H,nope) -> (B,S,H,kv_lora)."""
    wk, _ = _wkv_b_split(params, cfg)
    return torch.einsum("bshd,lhd->bshl", q_nope.float(), wk.float())


def _project_out(params: MLA, cfg: ModelConfig, out_lat: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """(probs · c) W^UV, then W^O: (B,S,H,kv_lora) fp32 -> (B,S,D)."""
    B, S = out_lat.shape[:2]
    _, wv = _wkv_b_split(params, cfg)
    out = torch.einsum("bshl,lhv->bshv", out_lat, wv.float())
    return out.to(dtype).reshape(B, S, -1) @ params.wo


def _absorbed_attend(params: MLA, x: torch.Tensor, cfg: ModelConfig,
                     q_nope: torch.Tensor, q_rope: torch.Tensor,
                     c_cache: torch.Tensor, kr_cache: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Absorbed MQA attention over a (B,T,·) latent view -> (B,S,D).

    scores_h = (q_nope_h W^UK_h) · c  +  q_rope_h · k_rope
    out_h    = (probs · c) W^UV_h"""
    out_lat = absorbed_probs_c(_absorb_query(params, cfg, q_nope), q_rope,
                               c_cache, kr_cache, mask, _scale(cfg))
    return _project_out(params, cfg, out_lat, x.dtype)


def mla_decode_absorbed(params: MLA, x: torch.Tensor, cfg: ModelConfig, *,
                        c_cache: torch.Tensor, kr_cache: torch.Tensor,
                        cache_index: int, positions: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed MQA-style decode over the contiguous latent cache.

    x (B,S,D); c_cache (B,T,kv_lora); kr_cache (B,T,rope), written IN PLACE
    at ``cache_index``.  Returns (out (B,S,D), c_cache, kr_cache)."""
    B, S, _ = x.shape
    q_nope, q_rope, c_new, kr_new = _absorbed_q_and_latents(
        params, x, cfg, positions)
    c_cache[:, cache_index:cache_index + S] = c_new.to(c_cache.dtype)
    kr_cache[:, cache_index:cache_index + S] = kr_new.to(kr_cache.dtype)
    T = c_cache.shape[1]
    kv_pos = torch.arange(T, device=x.device).expand(B, T)
    mask = attention_mask(positions, kv_pos, causal=True,
                          kv_len=cache_index + S)
    out = _absorbed_attend(params, x, cfg, q_nope, q_rope, c_cache,
                           kr_cache, mask)
    return out, c_cache, kr_cache


def mla_decode_paged(params: MLA, x: torch.Tensor, cfg: ModelConfig, *,
                     c_pool: torch.Tensor, kr_pool: torch.Tensor,
                     block_tables: torch.Tensor, positions: torch.Tensor,
                     impl: str = "kernel"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Absorbed decode over a PAGED latent cache (block pool + table).

    c_pool (nb,bs,kv_lora); kr_pool (nb,bs,rope); block_tables (B,mb);
    positions (B,S) absolute positions of x's tokens.  New latents are
    scattered through the table, in place.  With ``impl="kernel"`` a
    single-token step reads the latent pool in place through K3
    (``paged_mla_attend``) and a span through K4 (``paged_mla_prefill``,
    causal within the span, full attention to the cached prefix);
    ``impl="ref"`` gathers the view, whose index equals absolute position,
    so the causal mask alone masks the unwritten tail of each last block."""
    B, S, _ = x.shape
    q_nope, q_rope, c_new, kr_new = _absorbed_q_and_latents(
        params, x, cfg, positions)
    paged_update(c_pool, c_new, block_tables, positions)
    paged_update(kr_pool, kr_new, block_tables, positions)
    if S == 1 or impl != "ref":
        q_lat = _absorb_query(params, cfg, q_nope)
        attend = paged_mla_attend if S == 1 else paged_mla_prefill
        out_lat = attend(q_lat, q_rope, c_pool, kr_pool, block_tables,
                         positions[:, 0], scale=_scale(cfg), impl=impl)
        return _project_out(params, cfg, out_lat, x.dtype), c_pool, kr_pool
    c_view = paged_view(c_pool, block_tables)       # (B, mb*bs, kv_lora)
    kr_view = paged_view(kr_pool, block_tables)
    T = c_view.shape[1]
    kv_pos = torch.arange(T, device=x.device).expand(B, T)
    mask = attention_mask(positions, kv_pos, causal=True)
    out = _absorbed_attend(params, x, cfg, q_nope, q_rope, c_view, kr_view,
                           mask)
    return out, c_pool, kr_pool
