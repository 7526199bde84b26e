"""Direct Double-sided Importance Sampling (GLM-5 §4.1.2, Eq. 3–5).

Port of ``repro.rl.async_is`` (tensor functions; ``stop_gradient`` becomes
``.detach()``).

The asynchronous-RL objective: rollout engines are several weight-versions
stale, and tracking the exact behavior policy π_old would require a
checkpoint history.  GLM-5 instead (a) reuses the log-probs RECORDED AT
ROLLOUT TIME as the behavior proxy, r_t = exp(logπ_θ − logπ_rollout), and
(b) hard-masks tokens whose ratio leaves [1−ε_ℓ, 1+ε_h] (double-sided
calibration f(·), Eq. 5) instead of PPO's clipping — masked tokens
contribute no gradient at all.

  L(θ) = E_t[ f(r_t; ε_ℓ, ε_h) · Â_t · log π_θ(a_t|s_t) ]      (Eq. 3)
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def calibration_mask(r: torch.Tensor, eps_low: float = 0.2,
                     eps_high: float = 0.2) -> torch.Tensor:
    """f(x; ε_ℓ, ε_h) support indicator (Eq. 5)."""
    return ((r > 1.0 - eps_low) & (r < 1.0 + eps_high)).float()


class AsyncISStats(NamedTuple):
    loss: torch.Tensor
    kept_frac: torch.Tensor
    mean_ratio: torch.Tensor


def async_is_loss(logp_theta: torch.Tensor, logp_rollout: torch.Tensor,
                  advantages: torch.Tensor, mask: torch.Tensor, *,
                  eps_low: float = 0.2, eps_high: float = 0.2
                  ) -> AsyncISStats:
    """Eq. 3-5.  logp_* (B,T); advantages (B,); mask (B,T) = model tokens.

    Note the ``sg`` structure: the ratio r_t acts as a weight (detached),
    the gradient flows through log π_θ — exactly the Eq. 3 estimator.
    """
    r = torch.exp(logp_theta.detach() - logp_rollout)               # Eq. 4
    f = calibration_mask(r, eps_low, eps_high) * mask               # Eq. 5
    w = (f * r).detach() * advantages[:, None]
    tok = mask.sum().clamp_min(1.0)
    loss = -(w * logp_theta).sum() / tok                            # Eq. 3
    return AsyncISStats(loss=loss, kept_frac=f.sum() / tok,
                        mean_ratio=(r * mask).sum() / tok)


def staleness_keep(version_min: torch.Tensor, current_version: int,
                   tau: int) -> torch.Tensor:
    """§4.1.2 'dropping off-policy samples': drop if w' − w₀ > τ.

    ``version_min`` (B,) = oldest rollout-engine weight version per sample.
    Returns boolean keep mask."""
    return (current_version - version_min) <= tau


def pad_or_drop_group(valid: torch.Tensor) -> torch.Tensor:
    """§4.1.2 noisy-sample handling for one group (G,) of validity flags:
    returns per-sample REPLICATION COUNTS summing to G if >half the group is
    valid (pad by repeating valid samples round-robin), else all zeros (drop
    the whole group).  The sort is stable (``jnp.argsort``'s), so the extra
    copies go to the first valid samples in index order."""
    G = valid.shape[0]
    dev = valid.device
    n_valid = valid.sum()
    order = torch.argsort((~valid).to(torch.int8), stable=True)  # valid first
    ar = torch.arange(G, device=dev)
    vo = valid[order]
    needed = G - n_valid
    nv = n_valid.clamp_min(1)
    # distribute 'needed' extra copies over the first valid samples (cyclic)
    base = vo.long()
    reps = base + torch.where(vo, needed // nv + (ar < needed % nv).long(),
                              torch.zeros_like(ar))
    counts = torch.zeros(G, dtype=torch.int32, device=dev)
    counts[order] = reps.to(torch.int32)
    return torch.where(n_valid > G // 2, counts, torch.zeros_like(counts))
