"""Entry point of K9 in the model's layout (port of
``repro.kernels.flash_attention.ops.attend``).

The reference's ``attend`` repeats the KV heads G times and folds (B, H)
into the kernel's BH axis; the port's kernel maps query head ``h`` to KV
head ``h // G`` itself, so ``attend`` hands the tensors over as they are.
The device of the tensors picks the kernel (CUDA) or its plain version
(CPU); ``impl`` of the reference has no counterpart.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, d), k/v (B, T, KVH, d) -> (B, S, H, d)."""
    return kernel.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal=causal,
                                  window=window, softcap=softcap)
