"""Device resolution shared by the port's entry points.

The port runs on the GPU.  The CPU is used only when a caller asks for it
(``device="cpu"``, as the tests do); then every kernel wrapper runs its
plain PyTorch version because its tensors lie on the CPU.  Nothing falls
back to the CPU quietly.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means the GPU; raise when there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev
