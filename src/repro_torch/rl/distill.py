"""On-policy cross-stage distillation (GLM-5 §3.5, Eq. 2).

Port of ``repro.rl.distill`` (tensor functions; ``stop_gradient`` becomes
``.detach()``).

The FINAL post-training stage: stage-expert checkpoints (Reasoning-RL,
General-RL teachers) distill back into the student to undo cross-stage
forgetting.  Same loss as Eq. 1 but the advantage is replaced by the
per-token teacher/student log-ratio:

    Â_t = sg[ log π_teacher(y_t|·) − log π_student(y_t|·) ]      (Eq. 2)

Group size 1 (no group statistics needed — the advantage is direct), batch
1024 in the paper; rollouts come from the STUDENT (on-policy).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.grpo import pop_mask


class DistillStats(NamedTuple):
    loss: torch.Tensor
    mean_gap: torch.Tensor
    kept_frac: torch.Tensor


def onpolicy_distill_loss(logp_student: torch.Tensor,
                          logp_teacher: torch.Tensor,
                          logp_infer: torch.Tensor,
                          mask: torch.Tensor, *,
                          beta: float = 2.0,
                          eps_low: float = 0.2,
                          eps_high: float = 0.28) -> DistillStats:
    """All (B, T) per-token logprobs of the SAMPLED tokens.

    ``logp_infer``: student's inference-engine logprobs at sampling time
    (the pop() mismatch gate is kept from Eq. 1).
    """
    adv = (logp_teacher - logp_student).detach()                  # Eq. 2
    rho = torch.exp(logp_student.detach() - logp_infer)
    keep = pop_mask(rho, beta) * mask
    # r = π_train/π_train_old = 1 on-policy; loss reduces to -E[adv · logp]
    tok = mask.sum().clamp_min(1.0)
    loss = -(keep * adv * logp_student).sum() / tok
    return DistillStats(loss=loss,
                        mean_gap=(adv * mask).sum() / tok,
                        kept_frac=keep.sum() / tok)
