"""The train, prefill and serve steps (port of ``repro.launch.steps``).

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
(``vlm``), and what the dry run drives.

``make_train_step(..., freeze="all_but_indexer")`` is the DSA indexer's
warm-up (GLM-5 §2.1.1: the indexer trains, the base is frozen; the
reference's ``benchmarks.common.train_lm(freeze=...)``): every parameter
outside the indexers (a name without an ``idx`` part) takes a zero
gradient, the clip sees the indexers' norm alone, and the update moves
the indexers' parameters only, so the others stay bitwise as they were
(the reference zeroes their gradients and updates every leaf without
weight decay: the same values).  The top-k carries no gradient, so the
indexers learn through the 0.01 × KL term alone.

``mesh`` is a ``DeviceMesh`` of one rank (``launch.mesh.make_host_mesh``)
or None.  Every family's entry points take it: it reaches the
transformer's MoE layers, which pick the expert-parallel path by it
(``layers.moe.apply_moe``), and, with ``muon_sharded_ns``, Muon's
Newton–Schulz groups; the reference's activation constraints are
identities on one rank.  The parameters stay plain tensors on one rank:
placing them with ``distribute_tensor`` there would send every op, the
hand-written kernels' included, through DTensor's dispatch for no change
in value.  A mesh of
more than one rank raises ``NotImplementedError``: the sharded step (the
parameters as DTensors with ``sharding.tree_shardings``' placements) is
not ported, and nothing runs unsharded in its place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import TrainConfig
from repro_torch.layers.common import logits_from_hidden
from repro_torch.models import get_model
from repro_torch.optim import muon


def _one_rank(mesh) -> None:
    """Refuse a mesh of more than one rank."""
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError(
            f"a step on a mesh of {mesh.size()} ranks: the sharded step is "
            f"not ported (one rank only)")


FREEZE = (None, "all_but_indexer")


def trained_names(model: nn.Module, freeze: Optional[str]) -> list:
    """Names of the parameters a step with ``freeze`` updates: all of them
    (None), or the DSA indexers' (``"all_but_indexer"``: every name with
    an ``idx`` part, the reference's ``is_idx_path``)."""
    if freeze not in FREEZE:
        raise ValueError(f"freeze={freeze!r}: one of {FREEZE}")
    names = [k for k, _ in model.named_parameters()]
    if freeze is None:
        return names
    names = [k for k in names if "idx" in k.split(".")]
    if not names:
        raise ValueError(f"freeze={freeze!r}: {model.cfg.name} has no DSA "
                         f"indexer to train")
    return names


def make_train_step(model: nn.Module, *, mesh=None,
                    train_cfg: Optional[TrainConfig] = None,
                    lr: float = 2e-4,
                    muon_sharded_ns: bool = False,
                    freeze: Optional[str] = None) -> Callable:
    """Returns ``train_step(opt_state, batch, lr=lr) -> (opt_state,
    metrics)``; the model's parameters are trained in place (this turns
    their gradients on: with ``freeze``, those of the trained parameters
    only).  ``muon_sharded_ns`` passes the mesh to Muon; ``freeze`` is
    None or ``"all_but_indexer"`` (the indexer warm-up, see the module's
    docstring)."""
    tc = train_cfg or TrainConfig()
    cfg = model.cfg
    M = get_model(cfg)
    _one_rank(mesh)
    trained = trained_names(model, freeze)
    model.requires_grad_(freeze is None)
    params = dict(model.named_parameters())
    for k in trained:
        params[k].requires_grad_(True)
    updated = {k: params[k] for k in trained}
    axes = M.param_axes(model)

    def train_step(opt_state: muon.MuonState, batch: Dict[str, torch.Tensor],
                   lr: float = lr) -> Tuple[muon.MuonState, dict]:
        for p in params.values():
            p.grad = None
        total, metrics = M.loss(model, batch, mesh=mesh)
        total.backward()
        # a parameter the loss never reaches (the MTP block's indexer: the
        # head runs dense; the hybrid's indexer: its loss is dropped), or
        # a frozen one, has no gradient; JAX gives it zeros
        grads, gnorm = muon.global_norm_clip(
            {k: p.grad if p.grad is not None else torch.zeros_like(p)
             for k, p in params.items()}, tc.grad_clip)
        opt_state = muon.update(updated, grads, axes, opt_state, lr=lr,
                                cfg=cfg, weight_decay=tc.weight_decay,
                                split=tc.muon_split,
                                mesh=mesh if muon_sharded_ns else None)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def make_prefill_step(model: nn.Module, *, mesh=None) -> Callable:
    """Returns ``prefill_step(batch) -> logits (B, 1, V)``: the forward
    over ``batch["tokens"]`` (after ``batch["frontend_embeds"]`` where the
    batch has them) without a cache, the last position's logits."""
    M = get_model(model.cfg)
    _one_rank(mesh)

    @torch.no_grad()
    def prefill_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        kw = {"mesh": mesh}
        if "frontend_embeds" in batch:
            kw["frontend_embeds"] = batch["frontend_embeds"]
        h, _, _ = M.hidden(model, batch["tokens"], **kw)
        return logits_from_hidden(model.embed, h[:, -1:], model.cfg)

    return prefill_step


def make_serve_step(model: nn.Module, *, mesh=None) -> Callable:
    """Returns ``serve_step(token, cache, cache_index) -> (logits (B, 1,
    V), cache)``: one decode step of ``token`` (B, 1) at position
    ``cache_index`` against a contiguous cache the model's ``prefill``
    filled (updated in place)."""
    M = get_model(model.cfg)
    _one_rank(mesh)

    def serve_step(token: torch.Tensor, cache: dict,
                   cache_index) -> Tuple[torch.Tensor, dict]:
        return M.decode_step(model, token, cache, cache_index, mesh=mesh)

    return serve_step
