"""Decoder-only GQA transformer: the dense family of the reference.

Port of ``repro.models.transformer`` for configurations the port serves
exactly as the reference does: GQA attention, dense MLP (swiglu / relu2 /
gelu), ``first_k_dense`` layers, the ``attention_pattern`` layer groups
(local sliding-window / global), attention and final logit softcaps, tied
(gemma-scaled) embeddings and ``qk_norm``.  A config that needs a part not
ported yet — DSA, MLA, MoE, MTP, another family — raises
``NotImplementedError`` instead of quietly running dense attention.

Layout differences from the reference:

* parameters live in one ``Block`` module per layer (the reference stacks
  each pattern slot on a leading ``n_groups`` axis for ``lax.scan``; the
  weight bridge unstacks), and the layer loop is a Python loop;
* caches keep the reference's layout exactly: ``init_cache`` stacks each
  slot as ``(n_groups, B, T, KVH, d)``, ``init_paged_cache`` builds the
  LAYER-MAJOR flat pools ``(n_groups*num_blocks, bs, KVH, d)`` that group
  ``g`` addresses with ``block_tables + g*num_blocks``, so pools and block
  tables compare one to one with the reference's;
* caches are updated IN PLACE (the reference donates them to its jits);
  ``prefill`` / ``decode_step`` return the same cache object they were
  given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.paging import paged_update
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import (paged_gqa_attend,
                                                     paged_gqa_prefill)
from repro_torch.layers.attention import GQA, dense_attention, gqa_qkv
from repro_torch.layers.common import (MLP, Embedding, _empty, embed,
                                       logits_from_hidden, rmsnorm)

NORMS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every config this slice cannot serve as the reference does."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port serves the "
            f"dense GQA family)")
    if cfg.dsa is not None:
        raise NotImplementedError(
            "DSA sparse attention is the DSA slice, not ported yet; serve "
            "cfg.replace(dsa=None) for the dense architecture")
    if cfg.attention_type == "mla":
        raise NotImplementedError("MLA attention is the MLA slice, not "
                                  "ported yet")
    if cfg.num_experts > 0:
        raise NotImplementedError("MoE FFNs are not ported yet")
    if cfg.mtp is not None:
        raise NotImplementedError("the MTP head is the MTP slice, not "
                                  "ported yet")
    P = len(cfg.attention_pattern)
    if (cfg.num_layers - cfg.first_k_dense) % P:
        raise ValueError(f"{cfg.num_layers - cfg.first_k_dense} pattern "
                         f"layers do not tile the pattern {cfg.attention_pattern}")


def layer_kind(cfg: ModelConfig, i: int) -> str:
    if i < cfg.first_k_dense:
        return "global"
    pattern = cfg.attention_pattern
    return pattern[(i - cfg.first_k_dense) % len(pattern)]


def n_groups(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_k_dense) // len(cfg.attention_pattern)


class Block(nn.Module):
    """One decoder layer: pre-norm attention + pre-norm MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.attn_norm = _empty(cfg.d_model, **kw)
        self.attn = GQA(cfg, **kw)
        self.mlp_norm = _empty(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)


class Transformer(nn.Module):
    """Parameters of the whole decoder; ``forward(tokens)`` gives logits."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, layer_kind(cfg, i), **kw)
            for i in range(cfg.num_layers))
        self.final_norm = _empty(cfg.d_model, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return logits(self, tokens)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, dtype=torch.float32) -> Transformer:
    """Random model with the reference's scales (``sharding/rules.py``):
    matrices normal * fan_in^-1/2 with fan_in the input dim, the embedding
    normal * 1.0, norms at 1.  ``generator`` must live on ``device``; by
    default one seeded with 0 is made there.  The numbers differ from the
    reference's (a ``jax.random`` key is not a torch generator): carry JAX
    weights over with ``repro_torch.bridge.from_jax_params``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in NORMS:
                p.fill_(1.0)
                continue
            scale = 1.0 if leaf == "embedding" else p.shape[0] ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _attend(attn: GQA, h: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, kind: str, layer_cache,
            cache_index, block_tables: Optional[torch.Tensor],
            paged_impl: str) -> torch.Tensor:
    """Attention sub-layer on normed hidden h.

    ``layer_cache`` is None (no cache), a contiguous ``(k, v)`` pair of
    (B, T, KVH, d) views, or, with ``block_tables`` (this layer's table,
    already offset into the layer-major pool), the flat ``(k_pool,
    v_pool)``.  Paged single-token steps read KV in place through K1, spans
    through K2 (``paged_impl='ref'``: the gather oracle)."""
    B, S, _ = h.shape
    window = cfg.sliding_window if kind == "local" else 0
    softcap = cfg.attn_logit_softcap
    q, k, v = gqa_qkv(attn, h, cfg, positions)
    if layer_cache is None:
        out = dense_attention(q, k, v, positions, positions, causal=True,
                              window=window, softcap=softcap)
    elif block_tables is not None:
        k_pool, v_pool = layer_cache
        paged_update(k_pool, k, block_tables, positions)
        paged_update(v_pool, v, block_tables, positions)
        attend = paged_gqa_attend if S == 1 else paged_gqa_prefill
        out = attend(q, k_pool, v_pool, block_tables, positions[:, 0],
                     window=window, softcap=softcap, impl=paged_impl)
    else:
        k_cache, v_cache = layer_cache
        k_cache[:, cache_index:cache_index + S] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + S] = v.to(v_cache.dtype)
        T = k_cache.shape[1]
        kv_positions = torch.arange(T, device=h.device).expand(B, T)
        out = dense_attention(q, k_cache, v_cache, positions, kv_positions,
                              causal=True, window=window, softcap=softcap,
                              kv_len=cache_index + S)
    return out.reshape(B, S, -1) @ attn.wo


def apply_block(block: Block, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, layer_cache=None,
                cache_index=None, block_tables=None,
                paged_impl: str = "kernel") -> torch.Tensor:
    a_in = rmsnorm(h, block.attn_norm, cfg.norm_eps)
    h = h + _attend(block.attn, a_in, cfg, positions, block.kind,
                    layer_cache, cache_index, block_tables, paged_impl)
    m_in = rmsnorm(h, block.mlp_norm, cfg.norm_eps)
    return h + block.mlp(m_in)


def _layer_caches(cfg: ModelConfig, cache: dict, block_tables):
    """Per layer: (cache pair, block table) in layer order.  Paged slot
    pools are layer-major: group g reads rows ``g*stride + table``."""
    P = len(cfg.attention_pattern)
    ng = n_groups(cfg)
    for i in range(cfg.num_layers):
        if i < cfg.first_k_dense:
            c = cache[f"dense_{i}"]
            yield (c["k"], c["v"]), block_tables
            continue
        g, j = divmod(i - cfg.first_k_dense, P)
        c = cache[f"slot{j}"]
        if block_tables is None:
            yield (c["k"][g], c["v"][g]), None
        else:
            stride = c["k"].shape[0] // ng
            yield (c["k"], c["v"]), block_tables + g * stride


def hidden(model: Transformer, tokens: torch.Tensor, *,
           positions: Optional[torch.Tensor] = None,
           cache: Optional[dict] = None, cache_index=None,
           block_tables: Optional[torch.Tensor] = None,
           paged_impl: str = "kernel") -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (final-normed hidden (B, S, D), cache).

    With ``block_tables`` the cache is the paged block pool and
    ``cache_index`` the per-sequence start vector (B,); with a contiguous
    cache ``cache_index`` is the int offset of token 0."""
    cfg = model.cfg
    B, S = tokens.shape
    dev = tokens.device
    h = embed(model.embed, tokens, cfg)
    if positions is None:
        span = torch.arange(S, dtype=torch.int32, device=dev)
        if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
            positions = cache_index.to(torch.int32)[:, None] + span[None]
        else:
            positions = (span + int(cache_index or 0)).expand(B, S)
    layers = _layer_caches(cfg, cache, block_tables) if cache is not None \
        else ((None, None) for _ in model.layers)
    for block, (layer_cache, tables) in zip(model.layers, layers):
        h = apply_block(block, h, cfg, positions, layer_cache=layer_cache,
                        cache_index=cache_index, block_tables=tables,
                        paged_impl=paged_impl)
    return rmsnorm(h, model.final_norm, cfg.norm_eps), cache


def logits(model: Transformer, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full-vocab logits for every position (no cache unless given)."""
    h, _ = hidden(model, tokens, **kw)
    return logits_from_hidden(model.embed, h, model.cfg)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _kv(shape, dtype, device) -> Dict[str, torch.Tensor]:
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Contiguous cache: ``dense_i`` (B, T, KVH, d) leaves and stacked
    ``slotJ`` (n_groups, B, T, KVH, d) leaves, as the reference."""
    dev = resolve_device(device)
    f = (cfg.num_kv_heads, cfg.head_dim)
    cache = {f"dense_{i}": _kv((batch, max_len) + f, dtype, dev)
             for i in range(cfg.first_k_dense)}
    for j in range(len(cfg.attention_pattern)):
        cache[f"slot{j}"] = _kv((n_groups(cfg), batch, max_len) + f, dtype,
                                dev)
    return cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Block-pool KV cache: ``dense_i`` flat pools (num_blocks, bs, KVH, d)
    and LAYER-MAJOR ``slotJ`` pools (n_groups*num_blocks, bs, KVH, d);
    callers pass per-layer block ids in [0, num_blocks)."""
    dev = resolve_device(device)
    f = (block_size, cfg.num_kv_heads, cfg.head_dim)
    cache = {f"dense_{i}": _kv((num_blocks,) + f, dtype, dev)
             for i in range(cfg.first_k_dense)}
    for j in range(len(cfg.attention_pattern)):
        cache[f"slot{j}"] = _kv((n_groups(cfg) * num_blocks,) + f, dtype, dev)
    return cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: dict, *,
            block_tables: Optional[torch.Tensor] = None, cache_index=None,
            paged_impl: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """Fill the cache with the prompt; returns (logits, cache).

    Paged mode (``block_tables`` set) returns ALL-position logits (B, S, V)
    — the caller picks its own last real position per sequence; contiguous
    mode returns the last position's (B, 1, V)."""
    h, cache = hidden(model, tokens, cache=cache,
                      cache_index=0 if cache_index is None else cache_index,
                      block_tables=block_tables, paged_impl=paged_impl)
    if block_tables is None:
        h = h[:, -1:]
    return logits_from_hidden(model.embed, h, model.cfg), cache


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: dict,
                cache_index, *, block_tables: Optional[torch.Tensor] = None,
                paged_impl: str = "kernel") -> Tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V), cache).  With ``block_tables``
    ``cache_index`` is the per-sequence length vector (B,)."""
    h, cache = hidden(model, token, cache=cache, cache_index=cache_index,
                      block_tables=block_tables, paged_impl=paged_impl)
    return logits_from_hidden(model.embed, h, model.cfg), cache
