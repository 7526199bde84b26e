"""The train, prefill and serve steps (port of ``repro.launch.steps``,
on one device, with no mesh).

One step: the loss and its gradients (the config's model through the
registry: ``transformer.loss`` runs its forward through K9 / K7 / K8,
``ssm_model.loss`` through K11's Mamba-1 form, ``hybrid.loss`` through
K11's head-shared form and K9 or K7 in its shared block; the
cross-entropy through K10; the kernels' backwards are plain), global-norm
clipping, then the Muon(+Split) update, in place on the model's
parameters.  ``make_prefill_step`` is the forward over a whole prompt
(with the batch's ``frontend_embeds``: a VLM's patches, an
encoder-decoder's frames) to its last position's logits, with no cache;
``make_serve_step`` one decode step against a filled contiguous cache.
They are the reference's serve path for the families the paged engine
does not take (``audio``) and its prefill path with ``frontend_embeds``
(``vlm``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.layers.common import logits_from_hidden
from repro_torch.models import get_model
from repro_torch.optim import muon


def make_train_step(model: nn.Module, *,
                    train_cfg: Optional[TrainConfig] = None,
                    lr: float = 2e-4) -> Callable:
    """Returns ``train_step(opt_state, batch, lr=lr) -> (opt_state,
    metrics)``; the model's parameters are trained in place (this turns
    their gradients on)."""
    tc = train_cfg or TrainConfig()
    cfg = model.cfg
    M = get_model(cfg)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    axes = M.param_axes(model)

    def train_step(opt_state: muon.MuonState, batch: Dict[str, torch.Tensor],
                   lr: float = lr) -> Tuple[muon.MuonState, dict]:
        for p in params.values():
            p.grad = None
        total, metrics = M.loss(model, batch)
        total.backward()
        # a parameter the loss never reaches (the MTP block's indexer: the
        # head runs dense; the hybrid's indexer: its loss is dropped) has
        # no gradient; JAX gives it zeros
        grads, gnorm = muon.global_norm_clip(
            {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}, tc.grad_clip)
        opt_state = muon.update(params, grads, axes, opt_state, lr=lr,
                                cfg=cfg, weight_decay=tc.weight_decay,
                                split=tc.muon_split)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_prefill_step(model: nn.Module) -> Callable:
    """Returns ``prefill_step(batch) -> logits (B, 1, V)``: the forward
    over ``batch["tokens"]`` (after ``batch["frontend_embeds"]`` where the
    batch has them) without a cache, the last position's logits."""
    M = get_model(model.cfg)

    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        kw = {}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        h, _, _ = M.hidden(model, batch["tokens"], **kw)
        return logits_from_hidden(model.embed, h[:, -1:], model.cfg)

    return prefill_step


def make_serve_step(model: nn.Module) -> Callable:
    """Returns ``serve_step(token, cache, cache_index) -> (logits (B, 1,
    V), cache)``: one decode step of ``token`` (B, 1) at position
    ``cache_index`` against a contiguous cache the model's ``prefill``
    filled (updated in place)."""
    M = get_model(model.cfg)

    def serve_step(token: torch.Tensor, cache: dict,
                   cache_index) -> Tuple[torch.Tensor, dict]:
        return M.decode_step(model, token, cache, cache_index)

    return serve_step
