"""Mixture-of-Experts FFN on one device: routed top-k experts + shared expert.

Port of the single-device part of ``repro.layers.moe``.  The router is a
softmax over ``num_experts`` in fp32, top-k with the gates renormalized to
sum to 1, plus the Switch-style load-balance auxiliary loss.  The output is
the reference's ``_moe_dense`` function (every token's k selected expert
outputs, weighted by their gates and summed in top-k order) plus the
shared expert, but only the (token, expert) pairs the router chose are
computed: the tokens of each chosen expert are grouped and run through that
expert's SwiGLU as one matrix product.  ``_moe_dense`` runs all experts on
all tokens, which at 256 experts is 32x the routed work; the result is the
same function.

Ties in the router: ``jax.lax.top_k`` puts the lower expert index first
among equal probabilities; ``torch.topk`` promises no order, so the port
ranks with a stable descending sort, which keeps index order among equals.

The expert-parallel ``shard_map`` path of the reference waits for the mesh
slice.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import _empty

ROUTER_SCALE = 0.02     # the reference's explicit init scale for ``router``


class MoE(nn.Module):
    """Router, stacked expert weights (E, in, out) and the shared expert."""

    AXES = {"router": ("embed", None),
            "w_gate": ("experts", "embed_fsdp", "moe_mlp"),
            "w_up": ("experts", "embed_fsdp", "moe_mlp"),
            "w_down": ("experts", "moe_mlp", "embed_fsdp"),
            "ws_gate": ("embed_fsdp", "mlp"), "ws_up": ("embed_fsdp", "mlp"),
            "ws_down": ("mlp", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
        kw = dict(device=device, dtype=dtype)
        self.router = _empty(D, E, **kw)
        self.w_gate = _empty(E, D, Fe, **kw)
        self.w_up = _empty(E, D, Fe, **kw)
        self.w_down = _empty(E, Fe, D, **kw)
        if cfg.num_shared_experts:
            Fs = Fe * cfg.num_shared_experts
            self.ws_gate = _empty(D, Fs, **kw)
            self.ws_up = _empty(D, Fs, **kw)
            self.ws_down = _empty(Fs, D, **kw)


def router_topk(params: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (T, D) -> gates (T, k) fp32, expert ids (T, k) int64, aux loss.

    Experts are ranked by probability, the lower id first among equals."""
    logits = x.float() @ params.router.float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = order.values[:, :k], order.indices[:, :k]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch aux loss: E * sum_e f_e * p_e
    E = cfg.num_experts
    me = probs.mean(0)
    one_hot = F.one_hot(idx, E).float().sum(1)           # (T, E)
    ce = one_hot.mean(0) / k
    aux = E * (me * ce).sum()
    return gates, idx, aux


def _expert_ffn(w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, x: torch.Tensor,
                activation: str) -> torch.Tensor:
    """x (C, D) through one expert: (C, D) -> (C, D)."""
    h = x @ w_up
    if activation == "swiglu":
        h = F.silu(x @ w_gate) * h
    elif activation == "relu2":
        h = F.relu(h).square()
    elif activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ w_down


def _routed(params: MoE, x2d: torch.Tensor, gates: torch.Tensor,
            idx: torch.Tensor, activation: str) -> torch.Tensor:
    """Sum over each token's k chosen experts of gate * expert(x), running
    each chosen expert once on the tokens routed to it.  The k outputs of a
    token are summed in top-k order, as the reference sums them."""
    T, k = idx.shape
    flat = idx.reshape(-1)                       # (T*k,) slot t*k + j
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=params.w_up.shape[0])
    sel = torch.empty((T * k, x2d.shape[1]), dtype=x2d.dtype,
                      device=x2d.device)
    at = 0
    # one host read of the per-expert counts decides the loop
    for e, n in enumerate(counts.tolist()):
        if n == 0:
            continue
        slots = order[at:at + n]
        at += n
        sel[slots] = _expert_ffn(params.w_gate[e], params.w_up[e],
                                 params.w_down[e], x2d[slots // k],
                                 activation)
    sel = sel.reshape(T, k, -1)
    return (sel * gates[..., None].to(sel.dtype)).sum(1)


def apply_moe(params: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D), aux loss scalar)."""
    B, S, D = x.shape
    x2d = x.reshape(B * S, D)
    gates, idx, aux = router_topk(params, x2d, cfg)
    y2d = _routed(params, x2d, gates, idx, cfg.mlp_activation).to(x.dtype)
    if cfg.num_shared_experts:
        h = x2d @ params.ws_up
        g = x2d @ params.ws_gate
        y2d = y2d + (F.silu(g) * h) @ params.ws_down
    return y2d.reshape(B, S, D), aux * cfg.router_aux_coef
