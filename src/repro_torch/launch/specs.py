"""Abstract (``meta``) inputs and their placements for every arch x input
shape.

Port of ``repro.launch.specs``: everything the dry run needs to drive a
train, prefill or serve step without allocating — the model built on
``meta`` (the abstract parameters), Muon's state, the batch and the cache
— each with its placements resolved through the logical-axis rules
(``sharding.tree_shardings``).  The port's ``MuonState`` stands in the
reference's: momentum for every leaf and second moments for the AdamW
leaves only, fp32, with ``count`` a host integer.  The cache's logical
axes are the reference's ``cache_specs``, leaf for leaf (the port's
caches keep its layout, stacked leaves and all).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import get_model
from repro_torch.optim.muon import MuonState, _is_muon_param
from repro_torch.sharding.rules import (Sharding, resolve_spec,
                                        tree_shardings)
from repro_torch.utils import map_tree

ACT_DTYPE = torch.bfloat16


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    """Return a string if this (arch, shape) pair is skipped (DESIGN.md)."""
    if shape.name == "long_500k":
        if cfg.family == "audio":
            return ("enc-dec transcript positions bounded by design; 500k "
                    "autoregressive decode not meaningful (DESIGN.md)")
        if cfg.family not in ("ssm", "hybrid") and cfg.dsa is None:
            return "full-attention arch without a sub-quadratic variant"
    return None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _batch_sharding(x: torch.Tensor, mesh, rules) -> Sharding:
    return Sharding(mesh, resolve_spec(("batch",) + (None,) * (x.ndim - 1),
                                       x.shape, rules, mesh))


def train_batch_specs(cfg: ModelConfig, shape: InputShape, mesh, rules
                      ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    B, S = shape.global_batch, shape.seq_len
    F = cfg.frontend_tokens if cfg.frontend != "none" else 0
    S_text = S - F if cfg.family == "vlm" else S
    batch = {"tokens": _meta((B, S_text), torch.int32),
             "targets": _meta((B, S_text), torch.int32),
             "loss_mask": _meta((B, S_text), torch.float32)}
    if cfg.family == "vlm":
        batch["frontend_embeds"] = _meta((B, F, cfg.d_model), ACT_DTYPE)
    if cfg.family == "audio":
        batch["frontend_embeds"] = _meta(
            (B, cfg.encoder_seq_len, cfg.d_model), ACT_DTYPE)
    return batch, {k: _batch_sharding(v, mesh, rules)
                   for k, v in batch.items()}


def _attn_cache_axes(cfg: ModelConfig, kind: str) -> dict:
    """One attention layer's cache leaves' logical axes (the reference's
    ``transformer.cache_specs``; length axis 'kv_seq')."""
    if cfg.attention_type == "mla":
        c = {"c": ("batch", "kv_seq", "lora"),
             "kr": ("batch", "kv_seq", None)}
    else:
        c = {"k": ("batch", "kv_seq", "kv_heads", "head_dim"),
             "v": ("batch", "kv_seq", "kv_heads", "head_dim")}
    if cfg.dsa is not None and kind == "global":
        c["k_idx"] = ("batch", "kv_seq", None)
    return c


def _stacked(axes: dict) -> dict:
    return {k: ("layers",) + v for k, v in axes.items()}


def cache_axes(cfg: ModelConfig) -> dict:
    """The logical axes of ``init_cache``'s leaves, by family."""
    if cfg.family == "ssm":
        return {"conv": ("layers", "batch", "conv", "ssm_inner"),
                "ssm": ("layers", "batch", "ssm_inner", "ssm_state")}
    if cfg.family == "hybrid":
        return {"ssm": {"conv": ("layers", "batch", "conv", None),
                        "ssm": ("layers", "batch", "heads", None,
                                "ssm_state")},
                "kv": _stacked(_attn_cache_axes(cfg, "global"))}
    if cfg.family == "audio":
        kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
        return {"self": {"k": kv, "v": kv},
                "enc_out": ("batch", "seq", "embed")}
    axes = {f"dense_{i}": _attn_cache_axes(cfg, "global")
            for i in range(cfg.first_k_dense)}
    for j, kind in enumerate(cfg.attention_pattern):
        axes[f"slot{j}"] = _stacked(_attn_cache_axes(cfg, kind))
    return axes


def decode_specs(cfg: ModelConfig, shape: InputShape, mesh, rules
                 ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """serve_step inputs: one new token + a cache of ``shape.seq_len``;
    ``cache_index`` is the last position (a host integer, as the port's
    contiguous decode step takes it)."""
    B, T = shape.global_batch, shape.seq_len
    cache = get_model(cfg).init_cache(cfg, B, T, dtype=ACT_DTYPE,
                                      device="meta")
    token = _meta((B, 1), torch.int32)
    specs = {"token": token, "cache": cache, "cache_index": T - 1}
    shardings = {"token": _batch_sharding(token, mesh, rules),
                 "cache": tree_shardings(cache, cache_axes(cfg), rules,
                                         mesh)}
    return specs, shardings


def param_specs(cfg: ModelConfig, mesh, rules):
    """Returns (the model on ``meta`` in ``ACT_DTYPE``, its parameters'
    logical axes by name, their ``Sharding``s by name)."""
    M = get_model(cfg)
    model = M.init(cfg, device="meta", dtype=ACT_DTYPE)
    axes = M.param_axes(model)
    return model, axes, tree_shardings(model, axes, rules, mesh)


def opt_state_specs(params: Dict[str, torch.Tensor], axes, shardings):
    """Muon's state on ``meta`` (fp32) beside its ``Sharding``s: momentum
    like every parameter, second moments like the AdamW ones."""
    adamw = [k for k, p in params.items()
             if not _is_muon_param(axes[k], tuple(p.shape))]

    def f32(x):
        return _meta(x.shape, torch.float32)
    st = MuonState(momentum=map_tree(f32, params),
                   second={k: f32(params[k]) for k in adamw})
    sh = MuonState(momentum=dict(shardings),
                   second={k: shardings[k] for k in adamw})
    return st, sh

