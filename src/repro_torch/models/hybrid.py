"""Zamba2-style hybrid: a Mamba-2 backbone and ONE shared attention block
(family ``hybrid``).

Port of ``repro.models.hybrid``.  ``cfg.hybrid_attn_every`` Mamba-2 layers
form a group; after each group the single shared attention block (one
parameter set, zamba2's signature trick: ``transformer.Block(cfg,
"global", moe=False)``, attention and a dense MLP, run by
``transformer.apply_block``) is applied.  Each invocation has its own KV
cache.  DSA applies to the shared block only (the Mamba-2 layers are
already linear-time).  The Mamba-2 scans run K11's head-shared form
(``layers.ssm.apply_mamba2``); the shared block's paged attention runs
K1/K2, or K5/K6 with DSA, as the transformer's does.

``mesh`` (on ``hidden``, ``loss``, ``prefill``, ``decode_step``) is the
reference's keyword, a mesh of one rank or None: it reaches the shared
block's ``transformer.apply_block`` (no MoE there), and the reference's
activation constraints that read it are identities on one rank.

Layout differences from the reference:

* parameters live in one ``Layer`` module per Mamba-2 layer (the
  reference stacks them on a leading ``layers`` axis and scans over
  ``(groups, every)``; the weight bridge unstacks), and the loops are
  Python loops;
* the cache keeps the reference's layout: ``ssm`` holds the per-layer
  recurrent state, ``conv`` (L, B, W-1, E+2N) and ``ssm`` (L, B, H, P, N)
  in the dtype it was made in, layer ``i`` reading index ``i`` (one tensor
  a leaf, as ``ssm_model``'s cache, so that the engine resets or restores
  a slot's rows of every layer in one operation a leaf); ``kv`` the
  shared block's K/V (and indexer keys with DSA), stacked ``(G, B, T, *f)``
  contiguous or, paged, the LAYER-MAJOR pool ``(G*num_blocks, bs, *f)``
  that invocation ``g`` addresses with ``block_tables + g*num_blocks``;
* the cache is updated IN PLACE: ``prefill`` and ``decode_step`` return
  the cache object they were given.

``loss`` trains it as the reference's does: the Mamba-2 scans through
K11's head-shared form and its chunked plain backward, the shared block
through K9 (dense) or the DSA training path (K7), K10 for the loss.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dsa import W_HEAD_SCALE
from repro_torch.device import resolve_device
from repro_torch.layers.common import (Embedding, _empty, embed,
                                       logits_from_hidden, rmsnorm,
                                       unembed_matrix)
from repro_torch.layers.ssm import Mamba2, apply_mamba2, mamba2_state
from repro_torch.models import transformer as tfm
from repro_torch.models.losses import mean_xent
from repro_torch.models.transformer import param_axes  # noqa: F401


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every config this model cannot serve as the reference
    does."""
    if cfg.family != "hybrid":
        raise NotImplementedError(f"the hybrid model serves family 'hybrid', "
                                  f"got {cfg.family!r}")
    if cfg.ssm_version != 2:
        raise NotImplementedError(f"the hybrid model runs Mamba-2 layers "
                                  f"(ssm_version 2), got {cfg.ssm_version}")
    if cfg.hybrid_attn_every <= 0 or cfg.num_layers % cfg.hybrid_attn_every:
        raise ValueError(f"{cfg.num_layers} layers do not form groups of "
                         f"hybrid_attn_every={cfg.hybrid_attn_every}")
    if cfg.ssm_state <= 0 or cfg.ssm_head_dim <= 0 \
            or (cfg.ssm_expand * cfg.d_model) % cfg.ssm_head_dim:
        raise ValueError(f"Mamba-2 shapes: ssm_state {cfg.ssm_state}, "
                         f"d_inner {cfg.ssm_expand * cfg.d_model} in heads "
                         f"of {cfg.ssm_head_dim}")
    if cfg.attention_type != "gqa":
        raise NotImplementedError(f"the shared block's attention_type "
                                  f"{cfg.attention_type!r} is not ported")
    if cfg.dsa is not None and cfg.dsa.selector not in ("token", "block"):
        raise ValueError(f"DSA selector {cfg.dsa.selector!r}: the reference "
                         f"has 'token' and 'block'")


def n_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.hybrid_attn_every


class Layer(nn.Module):
    """One pre-norm Mamba-2 block with a residual."""

    AXES = {"norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm = _empty(cfg.d_model, device=device, dtype=dtype)
        self.mamba = Mamba2(cfg, device=device, dtype=dtype)


class HybridModel(nn.Module):
    """Parameters of the whole LM; ``forward(tokens)`` gives logits."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.shared_attn = tfm.Block(cfg, "global", moe=False, **kw)
        self.final_norm = _empty(cfg.d_model, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return logits(self, tokens)


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, dtype=torch.float32) -> HybridModel:
    """Random model with the reference's scales: the embedding normal * 1,
    every other matrix normal * shape[0]^-1/2 (the DSA head weights
    ``w_head`` * 0.02), norms at 1, each mixer's own
    (``Mamba2.reset_parameters``).  ``generator`` must live on ``device``;
    by default one seeded with 0 is made there.  Carry JAX weights over
    with ``repro_torch.bridge.from_jax_params``."""
    dev = resolve_device(device)
    model = HybridModel(cfg, device=dev, dtype=dtype)
    if dev.type == "meta":       # the abstract init: shapes and dtypes
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(p, scale):
        p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                            dtype=torch.float32) * scale)

    with torch.no_grad():
        for name, p in model.embed.named_parameters():
            draw(p, 1.0 if name == "embedding" else p.shape[0] ** -0.5)
        for layer in model.layers:
            layer.norm.fill_(1.0)
            layer.mamba.reset_parameters(generator)
        for name, p in model.shared_attn.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in tfm.NORMS:
                p.fill_(1.0)
            else:
                draw(p, W_HEAD_SCALE if leaf == "w_head"
                     else p.shape[0] ** -0.5)
        model.final_norm.fill_(1.0)
    return model


def _kv_cache(cfg: ModelConfig, cache: dict, g: int, block_tables):
    """Invocation g's (cache leaves, block table) of the shared block:
    contiguous leaves index the group; paged pools are layer-major, so the
    table is offset by g * num_blocks."""
    kv = cache["kv"]
    if block_tables is None:
        return {name: leaf[g] for name, leaf in kv.items()}, None
    stride = next(iter(kv.values())).shape[0] // n_groups(cfg)
    return kv, block_tables + g * stride


def hidden(model: HybridModel, tokens: torch.Tensor, *,
           sparse: Optional[bool] = None, cache: Optional[dict] = None,
           cache_index=None, block_tables: Optional[torch.Tensor] = None,
           paged_impl: str = "kernel", mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (final-normed hidden (B, S, D), aux loss 0, cache).

    Positions start at ``cache_index``, as ``transformer.hidden``: with
    ``block_tables`` the shared block's KV is the paged pool and
    ``cache_index`` the per-sequence start vector (B,); the Mamba-2 states
    stay per row of the batch (a scheduler slot's, or one slot's for a
    batch-1 span).  Without a cache the states start at 0 and are
    dropped."""
    cfg = model.cfg
    if sparse is None:
        sparse = cfg.dsa is not None
    B, S = tokens.shape
    span = torch.arange(S, dtype=torch.int32, device=tokens.device)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        positions = cache_index.to(torch.int32)[:, None] + span[None]
    else:
        positions = (span + int(cache_index or 0)).expand(B, S)
    every = cfg.hybrid_attn_every
    h = embed(model.embed, tokens, cfg)
    for i, layer in enumerate(model.layers):
        st = None if cache is None else \
            {name: leaf[i] for name, leaf in cache["ssm"].items()}
        y, new = apply_mamba2(layer.mamba, rmsnorm(h, layer.norm,
                                                   cfg.norm_eps),
                              cfg, state=st)
        h = h + y
        if st is not None:
            for name, leaf in st.items():
                leaf.copy_(new[name])
        if (i + 1) % every:
            continue
        layer_cache, tables = (None, None) if cache is None else \
            _kv_cache(cfg, cache, i // every, block_tables)
        h, _ = tfm.apply_block(model.shared_attn, h, cfg, positions,
                               sparse=sparse, layer_cache=layer_cache,
                               cache_index=cache_index, block_tables=tables,
                               paged_impl=paged_impl, mesh=mesh)
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    return h, h.new_zeros((), dtype=torch.float32), cache


def logits(model: HybridModel, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full-vocab logits for every position (no cache unless given)."""
    h, _, _ = hidden(model, tokens, **kw)
    return logits_from_hidden(model.embed, h, model.cfg)


def loss(model: HybridModel, batch: Dict[str, torch.Tensor], *, mesh=None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss``: the masked mean token NLL (K10) of
    ``hidden`` without a cache over ``tokens`` / ``targets`` (B, S) and
    ``loss_mask`` (default ones); returns (total, {"ce", "loss", "aux"})
    with ``aux`` 0.  As in the reference, the shared block's DSA indexer
    loss is dropped, so the indexer's weights get no gradient (the train
    step gives them zeros, as JAX's gradient is)."""
    cfg = model.cfg
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    h, aux, _ = hidden(model, batch["tokens"], mesh=mesh)
    total = mean_xent(h, unembed_matrix(model.embed, cfg), targets, mask,
                      chunk=cfg.loss_chunk)
    return total, {"ce": total, "loss": total, "aux": aux}


def _ssm_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    one = mamba2_state(cfg, batch, dtype, device)
    return {k: v.expand(cfg.num_layers, *v.shape).contiguous()
            for k, v in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Contiguous cache: ``ssm`` = the per-layer states (zeros) and ``kv``
    = the shared block's leaves stacked over its G invocations,
    (G, B, T, *f)."""
    dev = resolve_device(device)
    return {"ssm": _ssm_cache(cfg, batch, dtype, dev),
            "kv": tfm._layer_leaves(cfg, (n_groups(cfg), batch, max_len),
                                    "global", dtype, dev)}


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None, *,
                     batch: int) -> dict:
    """Paged cache: the shared block's KV as a LAYER-MAJOR flat block pool
    ``(G*num_blocks, block_size, *f)`` (invocation g owns rows
    ``[g*num_blocks, (g+1)*num_blocks)``) and the Mamba-2 states per slot
    (``batch`` = the scheduler's slots): a new sequence must have its
    slot's state reset on admission."""
    dev = resolve_device(device)
    return {"ssm": _ssm_cache(cfg, batch, dtype, dev),
            "kv": tfm._layer_leaves(cfg, (n_groups(cfg) * num_blocks,
                                          block_size), "global", dtype,
                                    dev)}


@torch.no_grad()
def prefill(model: HybridModel, tokens: torch.Tensor, cache: dict, *,
            block_tables: Optional[torch.Tensor] = None, cache_index=None,
            paged_impl: str = "kernel", mesh=None
            ) -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the states and the KV cache; returns
    (logits, cache): paged mode (``block_tables`` set) all positions'
    (B, S, V), contiguous mode the last position's (B, 1, V)."""
    h, _, cache = hidden(model, tokens, cache=cache,
                         cache_index=0 if cache_index is None else cache_index,
                         block_tables=block_tables, paged_impl=paged_impl,
                         mesh=mesh)
    if block_tables is None:
        h = h[:, -1:]
    return logits_from_hidden(model.embed, h, model.cfg), cache


@torch.no_grad()
def decode_step(model: HybridModel, token: torch.Tensor, cache: dict,
                cache_index, *, block_tables: Optional[torch.Tensor] = None,
                paged_impl: str = "kernel", mesh=None
                ) -> Tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V), cache).  With ``block_tables``
    ``cache_index`` is the per-sequence length vector (B,)."""
    h, _, cache = hidden(model, token, cache=cache, cache_index=cache_index,
                         block_tables=block_tables, paged_impl=paged_impl,
                         mesh=mesh)
    return logits_from_hidden(model.embed, h, model.cfg), cache
