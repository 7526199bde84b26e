"""The Pallas kernel's entry point (port of
``repro.kernels.mamba_scan.ops``): the selective scan on the contract form.

``impl="ref"`` is the explicit oracle (``ref.reference``), as in the
reference; ``impl="kernel"`` runs K11 (``kernel.mamba_scan``: its plain
version on CPU tensors).  The reference cuts S into ``seq_chunk``-step
chunks so that each Pallas call's streamed inputs fit VMEM, carrying the
state between them; the port's kernel streams time through shared memory a
tile at a time and walks S whole, so ``seq_chunk`` is taken for the
reference's signature and changes nothing.  The model reaches K11 through
``kernel.mamba1_scan`` (the model form) instead.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.mamba_scan import kernel
from repro_torch.kernels.mamba_scan.ref import reference

IMPLS = ("kernel", "ref")


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor, C: torch.Tensor,
                   h0: torch.Tensor, *, seq_chunk: int = 256,
                   impl: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """dA/dBx (B, S, E, N), C (B, S, N), h0 (B, E, N) -> (y (B, S, E),
    hT (B, E, N)) in dA.dtype."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "ref":
        return reference(dA, dBx, C, h0)
    return kernel.mamba_scan(dA.contiguous(), dBx.contiguous(),
                             C.contiguous(), h0.contiguous())
