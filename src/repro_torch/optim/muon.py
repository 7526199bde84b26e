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
reference returns new arrays); the state's buffers are updated in place
too.  The reference keeps a zeros tree of second moments for every leaf;
the port keeps them for the AdamW leaves only (the Muon leaves' are zeros
there and never read).  The reference's ``_ns_group_constraint`` shards
the Newton–Schulz groups over a mesh; on one device it is the identity,
so it is not here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig

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


def _muon_direction(m_buf: torch.Tensor, axes: Axes, cfg: ModelConfig,
                    split: bool) -> torch.Tensor:
    """NS-orthogonalize the trailing (m, n) matrix of ``m_buf``; leading
    axes are groups, and Muon Split also splits the head axis found in the
    trailing two dims."""
    shape = m_buf.shape
    m, n = shape[-2:]
    axes2 = tuple(axes[-2:]) if axes else (None, None)
    grouping = _split_shape(axes2, (m, n), cfg) if split else None
    if grouping is None:
        o = newton_schulz(m_buf.reshape(-1, m, n)) * _rms_scale((m, n))
        return o.reshape(shape)
    g, ms, ns, head_first = grouping
    if head_first:
        x = m_buf.reshape(-1, g, ms, ns)
    else:
        x = m_buf.reshape(-1, ms, g, ns).transpose(1, 2)
    o = newton_schulz(x.reshape(-1, ms, ns)) * _rms_scale((ms, ns))
    o = o.reshape(-1, g, ms, ns)
    if not head_first:
        o = o.transpose(1, 2)
    return o.reshape(shape)


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


@torch.no_grad()
def update(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
           axes: Dict[str, Axes], state: MuonState, *, lr: float,
           cfg: ModelConfig, momentum: float = 0.95, beta2: float = 0.95,
           eps: float = 1e-8, weight_decay: float = 0.0,
           split: bool = True) -> MuonState:
    """One optimizer step, in place on ``params`` and the state's buffers;
    returns the state with ``count`` advanced."""
    count = state.count + 1
    b1 = 0.9
    for k, p in params.items():
        g32 = grads[k].float()
        m = state.momentum[k]
        if _is_muon_param(axes[k], tuple(p.shape)):
            m_new = momentum * m.float() + g32
            d = _muon_direction(m_new, axes[k], cfg, split)
        else:                                  # AdamW fallback
            v = state.second[k]
            m_new = b1 * m.float() + (1 - b1) * g32
            v_new = beta2 * v.float() + (1 - beta2) * g32.square()
            mhat = m_new / (1 - b1 ** count)
            vhat = v_new / (1 - beta2 ** count)
            d = mhat / (vhat.sqrt() + eps)
            v.copy_(v_new)
        p.copy_(p.float() * (1 - lr * weight_decay) - lr * d)
        m.copy_(m_new)
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
