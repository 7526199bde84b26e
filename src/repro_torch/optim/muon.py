"""Muon optimizer with the GLM-5 *Muon Split* adaptation (§2.1, Table 1).

Port of ``repro.optim.muon``.  Muon orthogonalizes the momentum of 2-D
matmul parameters with Newton–Schulz iteration; Muon Split orthogonalizes
each attention head's slice of the fused projections (W^Q, W^O, the MLA
and indexer head projections) on its own.  Leaf by leaf as the reference:

* the split grouping comes from each parameter's logical axes
  (``models.transformer.param_axes``: 'heads' / 'kv_heads' /
  'index_heads' on the first or last dim) and the config's head counts;
* leading axes ('experts') are groups, each matrix orthogonalized alone;
* parameters that are not matrices, and the embedding / unembedding
  ('vocab'), take the AdamW branch, bias-corrected by ``count``;
* weight decay multiplies every parameter, norms included, on both
  branches.

Parameters are dictionaries of tensors by name (``named_parameters``).
``update`` writes the new values into the parameters in place (the
reference returns new arrays), and the state's buffers, with the
reference's arithmetic and no temporary of a leaf's size that it can do
without (the AdamW branch holds two beside the gradient).  The reference keeps a zeros tree of second moments for every leaf;
the port keeps them for the AdamW leaves only (the Muon leaves' are zeros
there and never read).

``update(..., mesh=)`` is the reference's ``muon_sharded_ns``, the
zero-redundant Muon of GLM-5 §2.4.1: on placed parameters (``DTensor``s)
the Newton–Schulz groups are sharded over the mesh so that each rank
orthogonalizes whole matrices locally, then the directions go back to
each leaf's placements (``_ns_group_constraint``: the reference's
candidate axes and divisibility rule).  The reference stacks each layer
leaf on a leading 'layers' axis, which is part of its group axis; the
port keeps a leaf a layer, so the Muon leaves that differ only in their
layer index (same shape, axes and placements) are stacked into one group
axis first (``_direction_groups``; off a mesh each leaf is a group of
one, and every leaf takes the one path, ``_stacked_directions``).  Each matrix's direction is the same
function of its momentum on any mesh; only where it is computed moves.
With plain parameters, or off a mesh, every rank computes every
direction (the identity constraint).  Global-norm clipping and the AdamW
branch act on placed tensors as on plain ones.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.rules import (is_placed, local_apply, mesh_axes,
                                        replicated, split_dim)

NS_COEFFS = (3.4445, -4.7750, 2.0315)
NS_STEPS = 5

Axes = Tuple[Optional[str], ...]


def newton_schulz(G: torch.Tensor, steps: int = NS_STEPS) -> torch.Tensor:
    """Orthogonalize each trailing (m, n) matrix of G (quintic NS, fp32);
    leading axes are a batch of independent matrices."""
    a, b, c = NS_COEFFS
    X = G.float()
    transposed = X.shape[-2] > X.shape[-1]
    if transposed:
        X = X.transpose(-2, -1)
    X = X / (torch.linalg.norm(X, dim=(-2, -1), keepdim=True) + 1e-7)
    for _ in range(steps):
        A = X @ X.transpose(-2, -1)
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X.transpose(-2, -1) if transposed else X


def _split_shape(axes: Axes, shape: Tuple[int, ...], cfg: ModelConfig
                 ) -> Optional[Tuple[int, int, int, bool]]:
    """Return (groups, m, n, head_first) for Muon-Split reshaping, or None."""
    heads = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "index_heads": cfg.dsa.index_heads if cfg.dsa else 0}
    if len(shape) == 2:
        for pos, name in ((1, axes[-1]), (0, axes[0])):
            h = heads.get(name, 0)
            if h and shape[pos] % h == 0 and h > 1:
                if pos == 1:
                    return h, shape[0], shape[1] // h, False
                return h, shape[0] // h, shape[1], True
    return None


def _is_muon_param(axes: Axes, shape: Tuple[int, ...]) -> bool:
    if len(shape) < 2:
        return False
    if "vocab" in axes:          # embeddings / unembed -> AdamW (Muon paper)
        return False
    # non-matmul 2D tensors (positional tables, conv filters, SSM A/state)
    if axes and axes[-1] in ("ssm_state",):
        return False
    if axes and axes[0] in ("seq", "conv"):
        return False
    return True


def _rms_scale(shape) -> float:
    # match AdamW RMS ~0.2-0.4 (muon convention): sqrt(max(1, m/n))
    return max(1.0, shape[-2] / shape[-1]) ** 0.5


def _ns_group_constraint(x: torch.Tensor, mesh) -> torch.Tensor:
    """Shard the leading Newton–Schulz group axis of a placed ``x`` (G, m,
    n) over the mesh, each matrix whole on one rank: the first of the
    reference's candidate axes — ('pod', 'data', 'model'), ('data',
    'model'), ('data',), ('model',), those the mesh has — whose size is
    larger than 1 and divides G; where none does, every rank takes every
    matrix (replicated).  The identity off a mesh and on a plain
    tensor."""
    if mesh is None or not is_placed(x):
        return x
    sizes = mesh_axes(mesh)
    g = x.shape[0]
    for cand in (tuple(a for a in ("pod", "data", "model") if a in sizes),
                 tuple(a for a in ("data", "model") if a in sizes),
                 ("data",), ("model",)):
        n = math.prod(sizes.get(a, 1) for a in cand)
        if cand and n > 1 and g % n == 0:
            return x.redistribute(mesh, tuple(
                Shard(0) if a in cand else Replicate() for a in sizes))
    return x.redistribute(mesh, replicated(mesh))


def _orthogonalize(x: torch.Tensor, mesh) -> torch.Tensor:
    """``newton_schulz`` of every matrix of ``x`` (G, m, n): on the local
    matrices of each rank where ``x`` is placed (``_ns_group_constraint``
    decides which rank takes which), the directions back in ``x``'s
    placements."""
    if not is_placed(x):
        return newton_schulz(x)

    def ns(t):
        # contiguous: a placed view's strides must match its local shard's
        return newton_schulz(t).contiguous()
    if mesh is None:
        # placed, without muon_sharded_ns: DTensor's ops on x's own
        # placements, which may leave the result sharded otherwise
        return ns(x).redistribute(x.device_mesh, x.placements)
    grouped = _ns_group_constraint(x, mesh)
    o = local_apply(ns, (grouped,), (grouped.placements,),
                    grouped.placements, mesh=grouped.device_mesh)
    return o.redistribute(x.device_mesh, x.placements)


def _grouping(axes: Axes, shape, cfg: ModelConfig, split: bool
              ) -> Optional[Tuple[int, int, int, bool]]:
    """Muon Split's head grouping of a leaf's trailing (m, n) matrix, or
    None (no split)."""
    axes2 = tuple(axes[-2:]) if axes else (None, None)
    return _split_shape(axes2, tuple(shape[-2:]), cfg) if split else None


def _in_fp32(t: torch.Tensor, f) -> torch.Tensor:
    """``f`` applied in place to ``t`` in fp32: to ``t`` itself where it is
    fp32 (no temporary of its size: GLM-5's vocabulary tables are 3.8 GB
    each), else to an fp32 copy that is written back; returns the fp32
    tensor."""
    t32 = t.float()
    f(t32)
    if t32 is not t:
        t.copy_(t32)
    return t32


@dataclass
class MuonState:
    momentum: Dict[str, torch.Tensor]   # muon: momentum buffer; adamw: m
    second: Dict[str, torch.Tensor]     # adamw leaves only: v
    count: int = 0


def init(params: Dict[str, torch.Tensor],
         axes: Dict[str, Axes]) -> MuonState:
    return MuonState(
        momentum={k: torch.zeros_like(p) for k, p in params.items()},
        second={k: torch.zeros_like(p) for k, p in params.items()
                if not _is_muon_param(axes[k], tuple(p.shape))})


def _group_form(x: torch.Tensor, axes: Axes, cfg: ModelConfig,
                split: bool):
    """A Muon leaf's momentum as its Newton–Schulz groups, (g, m, n): its
    leading axes ('experts') and, under Muon Split, the head axis found in
    its trailing two dims; and the function that puts such a tensor back
    into the leaf's shape."""
    shape = x.shape
    m, n = shape[-2:]
    grouping = _grouping(axes, shape, cfg, split)
    if grouping is None:
        return x.reshape(-1, m, n), lambda o: o.reshape(shape)
    g, ms, ns, head_first = grouping
    if head_first:
        return (split_dim(x, -2, (g, ms)).reshape(-1, ms, ns),
                lambda o: o.reshape(shape))
    x = split_dim(x, -1, (g, ns)).transpose(-3, -2)       # (..., g, m, ns)
    return (x.reshape(-1, ms, ns),
            lambda o: o.reshape(x.shape).transpose(-3, -2).reshape(shape))


def _direction_groups(params: Dict[str, torch.Tensor],
                      axes: Dict[str, Axes], cfg: ModelConfig, split: bool,
                      mesh) -> List[List[str]]:
    """The leaves whose directions are computed together: on placed
    parameters over a mesh, the Muon leaves that differ only in their
    layer index (same shape, axes and placements), which is the
    reference's stacked 'layers' group axis; otherwise one leaf each."""
    if mesh is None or not is_placed(*params.values()):
        return [[k] for k in params]
    groups: Dict[tuple, List[str]] = {}
    for k, p in params.items():
        key = (k,)
        if _is_muon_param(axes[k], tuple(p.shape)) and (
                p.ndim == 2 or _grouping(axes[k], p.shape, cfg,
                                         split) is None):
            key = (re.sub(r"\.\d+\.", ".#.", k), tuple(p.shape), axes[k],
                   getattr(p, "placements", None))
        groups.setdefault(key, []).append(k)
    return list(groups.values())


def _stacked_directions(m_bufs: List[torch.Tensor], axes: Axes,
                        cfg: ModelConfig, split: bool, mesh
                        ) -> List[torch.Tensor]:
    """The directions of same-shaped leaves at once: each leaf's groups
    first, the leaves stacked behind them, one (g·L, m, n) batch of
    matrices for ``_orthogonalize``, then each leaf's part back in its
    shape."""
    forms = [_group_form(b, axes, cfg, split) for b in m_bufs]
    g, ms, ns = forms[0][0].shape
    x = torch.stack([f for f, _ in forms], dim=1).reshape(-1, ms, ns)
    o = _orthogonalize(x, mesh) * _rms_scale((ms, ns))
    o = o.reshape(g, len(m_bufs), ms, ns)
    return [back(o[:, i]) for i, (_, back) in enumerate(forms)]


@torch.no_grad()
def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           axes: Dict[str, Axes], state: MuonState, *, lr: float,
           cfg: ModelConfig, momentum: float = 0.95, beta2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.0,
           split: bool = True, mesh=None) -> MuonState:
    """One optimizer step, in place on ``params`` and the state's buffers;
    returns the state with ``count`` advanced.  ``mesh`` shards the
    Newton–Schulz groups of placed parameters (see the module's
    docstring)."""
    count = state.count + 1
    b1 = 0.9

    def write(p, d):
        """p * (1 - lr wd) - lr d in p's fp32 form, d its scratch."""
        if is_placed(p):
            d = d.redistribute(p.device_mesh, p.placements)
        _in_fp32(p, lambda p32: p32.mul_(1 - lr * weight_decay).sub_(
            d.mul_(lr)))

    for names in _direction_groups(params, axes, cfg, split, mesh):
        k = names[0]
        if _is_muon_param(axes[k], tuple(params[k].shape)):
            m_new = [_in_fp32(state.momentum[n], lambda m, n=n: m.mul_(
                momentum).add_(grads[n].float())) for n in names]
            ds = _stacked_directions(m_new, axes[k], cfg, split, mesh)
            for n, d in zip(names, ds):
                write(params[n], d)
            continue
        g32 = grads[k].float()                 # AdamW fallback
        m = _in_fp32(state.momentum[k],
                     lambda m: m.mul_(b1).add_(g32 * (1 - b1)))
        v = _in_fp32(state.second[k], lambda v: v.mul_(beta2).add_(
            g32.square().mul_(1 - beta2)))
        denom = (v / (1 - beta2 ** count)).sqrt_().add_(eps)
        write(params[k], (m / (1 - b1 ** count)).div_(denom))
        del denom                  # before the next leaf's temporaries
    return MuonState(state.momentum, state.second, count)


@torch.no_grad()
def global_norm_clip(grads: Dict[str, torch.Tensor], max_norm: float
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Scale every gradient by min(1, max_norm / (global L2 norm + 1e-9)),
    in place; returns (grads, norm)."""
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    for g in grads.values():
        g.mul_(scale.to(g.dtype))
    return grads, norm
