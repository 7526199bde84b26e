"""Multi-Token Prediction with parameter sharing (GLM-5 §2.1, Table 2).

Port of ``repro.core.mtp``.  DeepSeek-V3 trains ONE MTP layer but
speculates 2+ tokens at inference, so its later drafts see inputs the layer
never trained on; GLM-5 runs ``num_predict`` (= 3) MTP steps in training
that all SHARE one layer's parameters: the same draft-model memory, a
higher accept length (2.76 vs 2.55 at 4 speculative steps).

Block-agnostic, as the reference: the model hands in the block it builds
(``make_block``) and the function that applies one (``apply_block``).
``MTP`` holds the head's weights, ``mtp_step`` is one step, and
``mtp_train_losses`` the training objective; ``speculative_accept_length``
is the Table-2 measurement's count.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.layers.common import _empty, rmsnorm


class MTP(nn.Module):
    """One MTP layer: [norm(h); norm(emb)] -> ``proj`` -> block, under the
    reference's names (``build_mtp``): ``h_norm``, ``e_norm``, ``proj``
    (2D, D) and ``block`` (shared) or ``block_0..n-1``."""

    AXES = {"h_norm": ("embed",), "e_norm": ("embed",),
            "proj": ("embed", "embed_fsdp")}

    def __init__(self, cfg: ModelConfig, make_block: Callable[[], nn.Module],
                 *, device=None, dtype=None):
        super().__init__()
        D = cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.h_norm = _empty(D, **kw)
        self.e_norm = _empty(D, **kw)
        self.proj = _empty(2 * D, D, **kw)
        if cfg.mtp.share_params:
            self.block = make_block()
        else:
            for j in range(cfg.mtp.num_predict):
                setattr(self, f"block_{j}", make_block())

    def block_for(self, cfg: ModelConfig, j: int) -> nn.Module:
        return self.block if cfg.mtp.share_params \
            else getattr(self, f"block_{j}")


def mtp_step(mtp: MTP, cfg: ModelConfig, h: torch.Tensor,
             emb_next: torch.Tensor, positions: torch.Tensor, j: int,
             apply_block: Callable) -> torch.Tensor:
    """h (B, S, D) the previous step's hidden; emb_next (B, S, D) the
    embeddings of the j-th future input tokens.  Returns the new hidden."""
    x = torch.cat([rmsnorm(h, mtp.h_norm, cfg.norm_eps),
                   rmsnorm(emb_next, mtp.e_norm, cfg.norm_eps)], dim=-1)
    return apply_block(mtp.block_for(cfg, j), x @ mtp.proj, positions)


def mtp_train_losses(mtp: MTP, cfg: ModelConfig, h_trunk: torch.Tensor,
                     tokens: torch.Tensor, targets: torch.Tensor,
                     positions: torch.Tensor, embed_fn: Callable,
                     logits_loss_fn: Callable,
                     apply_block: Callable) -> torch.Tensor:
    """Mean CE over the ``num_predict`` MTP steps.  Step j predicts token
    t+1+j from the state at t: inputs and targets are rolled left by j and
    the last j positions masked out (``logits_loss_fn(h, targets, valid)``),
    shapes kept as the reference keeps them."""
    S = tokens.shape[1]
    n = cfg.mtp.num_predict
    h = h_trunk
    total = 0.0
    for j in range(1, n + 1):
        in_tok = torch.roll(tokens, -j, dims=1)
        tgt = torch.roll(targets, -j, dims=1)
        valid = (torch.arange(S, device=tokens.device) < S - j)[None]
        h = mtp_step(mtp, cfg, h, embed_fn(in_tok), positions, j - 1,
                     apply_block)
        total = total + logits_loss_fn(h, tgt, valid)
    return total / n


def speculative_accept_length(draft_tokens: torch.Tensor,
                              verify_argmax: torch.Tensor) -> torch.Tensor:
    """Accept length per row = 1 + the length of the matching prefix of
    draft_tokens (B, n) against the model's greedy verify_argmax (B, n)."""
    match = (draft_tokens == verify_argmax).to(torch.int64)
    return 1 + torch.cumprod(match, dim=1).sum(dim=1)
