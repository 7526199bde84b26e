"""The training step (port of ``repro.launch.steps.make_train_step``).

One step: the loss and its gradients (the config's model through the
registry: ``transformer.loss`` runs its forward through K9 / K7 / K8,
``ssm_model.loss`` through K11's Mamba-1 form, ``hybrid.loss`` through
K11's head-shared form and K9 or K7 in its shared block; the
cross-entropy through K10; the kernels' backwards are plain), global-norm
clipping, then the Muon(+Split) update, in place on the model's
parameters.  ``make_prefill_step`` /
``make_serve_step`` of the reference are the serving engine's job in the
port.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
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
