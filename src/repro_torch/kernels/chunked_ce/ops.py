"""Entry point of K10 over (B, S) tokens (port of
``repro.kernels.chunked_ce.ops.xent_loss``): flattens the tokens and hands
them to the kernel wrapper, whose tensors' device picks the kernel (CUDA)
or its plain version (CPU)."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.chunked_ce import kernel


def xent_loss(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, *, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, D), w (D, V), targets/mask (B, S) -> (loss_sum, count)."""
    B, S, D = h.shape
    return kernel.chunked_ce(
        h.reshape(B * S, D).contiguous(), w.contiguous(),
        targets.reshape(B * S).to(torch.int32).contiguous(),
        mask.reshape(B * S).float().contiguous(), softcap=softcap)
