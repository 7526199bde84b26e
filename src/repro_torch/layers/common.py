"""Shared primitives: RMSNorm, RoPE, MLPs, embedding / output head.

Port of ``repro.layers.common``.  Weights keep the reference's (in, out)
layout and are applied as ``x @ W``, so the weight bridge copies them
without a transpose.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig


def _empty(*shape, device=None, dtype=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in fp32, returned in ``x.dtype``."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


# ---------------------------------------------------------------------------
# rotary embeddings (split-half convention, as the reference)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, base: float, device=None) -> torch.Tensor:
    return 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  The two
    HALVES of the head dim rotate together (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], base, x.device)
    angles = positions[..., None].float() * freqs            # (..., S, hd/2)
    sin = torch.sin(angles)[..., None, :]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (swiglu / squared-relu / gelu)
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    AXES = {"w_gate": ("embed_fsdp", "mlp"), "w_up": ("embed_fsdp", "mlp"),
            "w_down": ("mlp", "embed_fsdp")}

    def __init__(self, d_model: int, d_ff: int, activation: str, *,
                 device=None, dtype=None):
        super().__init__()
        self.activation = activation
        if activation == "swiglu":
            self.w_gate = _empty(d_model, d_ff, device=device, dtype=dtype)
        self.w_up = _empty(d_model, d_ff, device=device, dtype=dtype)
        self.w_down = _empty(d_ff, d_model, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp(self, x, self.activation)


def mlp(params: MLP, x: torch.Tensor, activation: str) -> torch.Tensor:
    h = x @ params.w_up
    if activation == "swiglu":
        h = F.silu(x @ params.w_gate) * h
    elif activation == "relu2":          # nemotron squared-ReLU
        h = F.relu(h).square()
    elif activation == "gelu":           # jax.nn.gelu's default: tanh form
        h = F.gelu(h, approximate="tanh")
    else:
        raise ValueError(activation)
    return h @ params.w_down


# ---------------------------------------------------------------------------
# embedding + output head
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    AXES = {"embedding": ("vocab", "embed"), "unembed": ("embed_fsdp", "vocab")}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.embedding = _empty(cfg.vocab_size, cfg.d_model, device=device,
                                dtype=dtype)
        if not cfg.tie_embeddings:
            self.unembed = _empty(cfg.d_model, cfg.vocab_size, device=device,
                                  dtype=dtype)


def embed(params: Embedding, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    e = params.embedding[tokens.long()]
    if cfg.tie_embeddings:   # gemma-style scaled embeddings
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype)
    return e


def unembed_matrix(params: Embedding, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params.embedding.T
    return params.unembed


def logits_from_hidden(params: Embedding, h: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    logits = h @ unembed_matrix(params, cfg)
    if cfg.final_logit_softcap > 0:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
