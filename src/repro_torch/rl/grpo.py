"""GRPO + IcePop — GLM-5's Reasoning-RL objective (Eq. 1, §3.2).

Port of ``repro.rl.grpo`` (tensor functions; ``stop_gradient`` becomes
``.detach()``).

* π_train vs π_infer: rollouts are sampled by the INFERENCE engine whose
  numerics differ from the training engine (bf16 vs fp32 here; FP8 in the
  paper).  The per-token mismatch ratio ρ = π_train_old / π_infer gates the
  loss through the IcePop ``pop`` operator: tokens with ρ outside [1/β, β]
  are dropped (gradient-masked).  No KL term (removed vs original IcePop).
* PPO-style asymmetric clip with ε_low=0.2, ε_high=0.28 (paper defaults).
* group-normalized advantage over G samples per prompt: the population
  std (ddof 0, ``jnp.std``'s), so ``correction=0``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def group_advantages(rewards: torch.Tensor, eps: float = 1e-6
                     ) -> torch.Tensor:
    """rewards (n_prompts, G) -> normalized advantages (n_prompts, G)."""
    mean = rewards.mean(dim=1, keepdim=True)
    std = rewards.std(dim=1, keepdim=True, correction=0)
    return (rewards - mean) / (std + eps)


def pop_mask(rho: torch.Tensor, beta: float = 2.0) -> torch.Tensor:
    """IcePop pop(·): keep tokens whose train/infer mismatch is in
    [1/β, β]; zero (mask) the rest."""
    return ((rho >= 1.0 / beta) & (rho <= beta)).float()


class GRPOStats(NamedTuple):
    loss: torch.Tensor
    kept_frac: torch.Tensor
    clip_frac: torch.Tensor
    mean_ratio: torch.Tensor
    entropy_proxy: torch.Tensor


def grpo_icepop_loss(logp_train: torch.Tensor,
                     logp_train_old: torch.Tensor,
                     logp_infer: torch.Tensor,
                     advantages: torch.Tensor,
                     mask: torch.Tensor, *,
                     beta: float = 2.0,
                     eps_low: float = 0.2,
                     eps_high: float = 0.28) -> GRPOStats:
    """Eq. 1.  All logprob tensors are (B, T) per-token; ``advantages``
    (B,) per-sequence (outcome reward); ``mask`` (B, T) marks model-generated
    tokens (environment/tool tokens excluded per §4.1).
    """
    rho = torch.exp(logp_train_old - logp_infer)          # train-infer mismatch
    keep = pop_mask(rho, beta) * mask
    r = torch.exp(logp_train - logp_train_old)            # PPO ratio
    adv = advantages[:, None]
    unclipped = r * adv
    clipped = torch.clamp(r, 1.0 - eps_low, 1.0 + eps_high) * adv
    per_tok = torch.minimum(unclipped, clipped)
    # 1/|y| length normalization, then group mean
    tok_count = mask.sum(dim=1).clamp_min(1.0)
    per_seq = (keep * per_tok).sum(dim=1) / tok_count
    loss = -per_seq.mean()
    denom = mask.sum().clamp_min(1.0)
    return GRPOStats(
        loss=loss,
        kept_frac=keep.sum() / denom,
        clip_frac=((clipped < unclipped).float() * mask).sum() / denom,
        mean_ratio=(r * mask).sum() / denom,
        entropy_proxy=-(logp_train * mask).sum() / denom,
    )
