"""Differentiable entry point of K7 (the port's counterpart of
``repro.kernels.lightning_indexer.ops.indexer_scores``, over the indexer's
projected queries rather than its parameters, so that ``core.dsa`` keeps
the projections).

``indexer_scores`` runs the kernel wrapper (the tensors' device picks the
kernel or its plain version) inside a ``torch.autograd.Function`` whose
backward is plain PyTorch: the reference has no backward kernel, and JAX
differentiates its XLA ``indexer_scores``.  The backward recomputes the
per-head dot products and gives the gradients of the queries, the
(softmaxed) head weights and the keys; ReLU's gradient at exactly 0 is 0,
as in JAX.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.lightning_indexer import kernel


class _IndexerScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, w, k_idx):
        B, S, Hi, Di = q.shape
        ctx.save_for_backward(q, w, k_idx)
        return kernel.lightning_indexer(
            q.reshape(B, S, Hi * Di).contiguous(), w.float().contiguous(),
            k_idx.contiguous(), heads=Hi, head_dim=Di)

    @staticmethod
    def backward(ctx, g):
        q, w, k_idx = ctx.saved_tensors
        scale = q.shape[-1] ** -0.5
        qf, kf, wf = q.float(), k_idx.float(), w.float()
        dots = torch.einsum("bshd,btd->bsht", qf, kf)
        relu = torch.relu(dots) * scale
        dw = torch.einsum("bst,bsht->bsh", g, relu)
        gd = (g[:, :, None, :] * wf[..., None]) * (dots > 0) * scale
        dq = torch.einsum("bsht,btd->bshd", gd, kf)
        dk = torch.einsum("bsht,bshd->btd", gd, qf)
        return dq.to(q.dtype), dw.to(w.dtype), dk.to(k_idx.dtype)


def indexer_scores(q: torch.Tensor, w: torch.Tensor,
                   k_idx: torch.Tensor) -> torch.Tensor:
    """q (B, S, Hi, Di), w (B, S, Hi) softmaxed head weights, k_idx
    (B, T, Di) -> scores (B, S, T) fp32, differentiable in all three."""
    return _IndexerScores.apply(q, w, k_idx)
