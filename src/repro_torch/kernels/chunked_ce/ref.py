"""Plain PyTorch K10: the function the chunked cross-entropy kernel computes.

Port of ``repro.kernels.chunked_ce.ref.reference`` (which is the model's
``chunked_softmax_xent`` over one chunk): for each token the logits
h·W in fp32 (bf16 inputs are widened first, as the Pallas kernel does),
soft-capped c·tanh(z/c) when c > 0, and ``logsumexp(z) - z[target]``;
summed with the mask, and the mask summed.
Tokens are taken ``T_CHUNK`` at a time, which bounds the (rows, V) fp32
logits and changes no value beyond the order of the sums.
"""
from __future__ import annotations

from typing import Tuple

import torch

T_CHUNK = 512


def reference(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
              mask: torch.Tensor, *, softcap: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (Tk, D), w (D, V), targets/mask (Tk,) -> (loss_sum, count) fp32."""
    loss = torch.zeros((), dtype=torch.float32, device=h.device)
    wf = w.float()
    for lo in range(0, h.shape[0], T_CHUNK):
        z = h[lo:lo + T_CHUNK].float() @ wf
        if softcap > 0:
            z = softcap * torch.tanh(z / softcap)
        t = targets[lo:lo + T_CHUNK].long()
        nll = torch.logsumexp(z, -1) - z.gather(1, t[:, None])[:, 0]
        loss = loss + (nll * mask[lo:lo + T_CHUNK].float()).sum()
    return loss, mask.float().sum()
