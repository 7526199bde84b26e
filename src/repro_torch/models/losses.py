"""Sequence-chunked output projection + cross-entropy (GLM-5 §2.4.1).

Port of ``repro.models.losses``.  The forward runs K10
(``kernels.chunked_ce``): the masked token NLLs are summed without
(tokens, V) logits ever in device memory (on CPU tensors: its plain
version, a chunk of tokens at a time).  The reference keeps its chunks'
logits out of the backward's memory with ``jax.checkpoint`` per chunk;
here the backward is a plain PyTorch pass over ``chunk`` tokens at a time
that recomputes the chunk's logits ``h_c @ W``, applies the softcap and its
derivative, takes softmax minus one-hot at the target, scales by the mask
and the incoming gradient, and accumulates ``dh = g Wᵀ`` and
``dW += h_cᵀ g``.  ``chunk`` changes the backward's memory, never a value.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.chunked_ce import ops as ce_ops
from repro_torch.sharding.rules import (batch_placements, is_placed,
                                        local_apply, partial_over,
                                        replicated)


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, unembed, targets, mask, chunk, softcap):
        ctx.save_for_backward(h, unembed, targets, mask)
        ctx.chunk, ctx.softcap = chunk, softcap
        loss, count = ce_ops.xent_loss(h, unembed, targets, mask,
                                       softcap=softcap)
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, g_count):
        h, W, targets, mask = ctx.saved_tensors
        c = ctx.softcap
        D = h.shape[-1]
        hf = h.reshape(-1, D)
        tf = targets.reshape(-1).long()
        scale = mask.reshape(-1).float() * g_loss
        dh = torch.empty_like(hf)
        dW = torch.zeros(W.shape, dtype=torch.float32, device=W.device)
        step = ctx.chunk if ctx.chunk > 0 else hf.shape[0]
        for lo in range(0, hf.shape[0], step):
            hi = min(lo + step, hf.shape[0])
            hc = hf[lo:hi]
            z = (hc @ W).float()
            if c > 0:
                th = torch.tanh(z / c)
                z = c * th
            g = torch.softmax(z, dim=-1)
            g[torch.arange(hi - lo, device=g.device), tf[lo:hi]] -= 1.0
            g *= scale[lo:hi, None]
            if c > 0:
                g *= 1.0 - th * th
            g = g.to(W.dtype)
            dh[lo:hi] = g @ W.T
            dW += (hc.T @ g).float()
        return dh.reshape(h.shape), dW.to(W.dtype), None, None, None, None


def chunked_softmax_xent(h: torch.Tensor, unembed: torch.Tensor,
                         targets: torch.Tensor, mask: torch.Tensor, *,
                         chunk: int = 512, softcap: float = 0.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h (B, S, D), unembed (D, V), targets/mask (B, S) -> (sum of masked
    token NLL, number of masked-in tokens), fp32 scalars.

    Placed (``DTensor``) inputs run K10 on each rank's shard of the batch
    with the whole unembedding: the rules shard its 'vocab' over 'model'
    and K10 needs every vocabulary column of a token, so it is gathered
    over 'model' (and over 'data', where FSDP shards its rows) first.
    Each rank's sums are a part of the batch's (``Partial`` over the batch
    axes), as is its unembedding gradient."""
    def xent(h, unembed, targets, mask):
        return _ChunkedXent.apply(h, unembed, targets, mask, chunk, softcap)

    if not is_placed(h, unembed, targets, mask):
        return xent(h, unembed, targets, mask)
    mesh = next(t for t in (h, unembed, targets, mask)
                if is_placed(t)).device_mesh
    rows = batch_placements(mesh, h.shape[0])
    whole = replicated(mesh)
    batch_axes = [a for a, p in zip(mesh.mesh_dim_names, rows)
                  if p.is_shard()]
    summed = partial_over(whole, mesh, batch_axes)
    return local_apply(xent, (h, unembed, targets, mask),
                       (rows, whole, rows, rows), (summed, summed),
                       grad_placements=(rows, summed, rows, rows),
                       mesh=mesh)


def mean_xent(h, unembed, targets, mask, *, chunk: int = 512,
              softcap: float = 0.0) -> torch.Tensor:
    loss, count = chunked_softmax_xent(h, unembed, targets, mask,
                                       chunk=chunk, softcap=softcap)
    return loss / count.clamp_min(1.0)


def token_logprobs(logits: torch.Tensor, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """logits (B, S, V), tokens (B, S) -> log pi(token) (B, S) in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return logp.gather(-1, tokens.long()[..., None])[..., 0]
