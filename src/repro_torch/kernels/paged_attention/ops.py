"""Dispatch for paged GQA attention: in-place block reads vs gather.

Port of the reference's ``kernels/paged_attention/ops.py`` (GQA part).  The
model calls these with its own layout, q (B, S, H, d) with head
``h = kvh*G + g``, and they pack the queries the way the kernels take them.

``impl`` takes two values:

* ``"kernel"`` (default) — read KV blocks in place: K1 for a decode step,
  K2 for a span.  The tensor's device decides how: a CUDA tensor launches
  the hand-written kernel (or raises), a CPU tensor runs the kernel's plain
  PyTorch version.  No switch puts the plain version on the card.
* ``"ref"`` — the ``paged_view`` gather oracle (``ref.py``), explicitly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention import kernel as _k
from repro_torch.kernels.paged_attention import prefill as _p
from repro_torch.kernels.paged_attention import ref as _ref

IMPLS = ("kernel", "ref")


def check_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def paged_gqa_attend(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, *, window: int = 0,
                     softcap: float = 0.0,
                     impl: str = "kernel") -> torch.Tensor:
    """Decode-step GQA attention through the block table.

    q (B, 1, H, d); pools (nb, bs, KVH, d); ``seq_lens[b]`` is the query
    position -> (B, 1, H, d)."""
    if check_impl(impl) == "ref":
        return _ref.paged_gqa_reference(q, k_pool, v_pool, block_tables,
                                        seq_lens, window=window,
                                        softcap=softcap)
    B, S, H, d = q.shape
    KVH = k_pool.shape[2]
    qg = q[:, 0].reshape(B, KVH, H // KVH, d).contiguous()  # head groups
    out = _k.paged_decode_gqa(qg, k_pool, v_pool, block_tables,
                              seq_lens.to(torch.int32).contiguous(),
                              window=window, softcap=softcap)
    return out.reshape(B, 1, H, d)


def paged_gqa_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      starts: torch.Tensor, *, window: int = 0,
                      softcap: float = 0.0,
                      impl: str = "kernel") -> torch.Tensor:
    """Span-prefill GQA attention through the block table, in place.

    q (B, S, H, d): query i of row b sits at position ``starts[b] + i`` and
    its K/V were scattered before the call -> (B, S, H, d)."""
    if check_impl(impl) == "ref":
        return _ref.paged_gqa_prefill_reference(
            q, k_pool, v_pool, block_tables, starts, window=window,
            softcap=softcap)
    B, S, H, d = q.shape
    KVH = k_pool.shape[2]
    G = H // KVH
    # head-group packing: (B, KVH, S*G, d) rows are (token i, group g)
    qp = q.reshape(B, S, KVH, G, d).permute(0, 2, 1, 3, 4) \
        .reshape(B, KVH, S * G, d).contiguous()
    out = _p.paged_prefill_gqa(qp, k_pool, v_pool, block_tables,
                               starts.to(torch.int32).contiguous(), groups=G,
                               window=window, softcap=softcap)
    return out.reshape(B, KVH, S, G, d).permute(0, 2, 1, 3, 4) \
        .reshape(B, S, H, d)
