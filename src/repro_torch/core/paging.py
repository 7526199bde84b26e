"""Paged KV-cache primitives: block-pool scatter/gather through block tables.

Port of ``repro.core.paging``.  A *block pool* stores KV state for all
in-flight sequences as a flat pool of fixed-size blocks: every pool leaf is
shaped ``(num_blocks, block_size, *f)``.  A sequence addresses the pool
through a *block table* — row b of a ``(B, max_blocks)`` int32 tensor lists
the blocks owned by sequence b, in position order, so absolute token
position ``p`` lives at ``(table[b, p // block_size], p % block_size)``.

Multi-layer models flatten the layer axis into the block axis (a
*layer-major* pool): layer ``l``'s copy of block ``b`` lives at row
``l*stride + b`` and layer ``l`` addresses the pool with
``block_tables + l*stride``.

The JAX package makes its writes cheap by donating the pool to its jits.
PyTorch has no donation; instead ``paged_update``, ``copy_block`` and
``copy_block_strided`` write IN PLACE into the preallocated pool
(``index_copy_``/``index_put_``) and return the same tensor, so a decode
step moves only the rows it touches.  Idle slots all scatter into the
trash block: duplicate indices there leave an unspecified winner, which is
harmless because the trash block is never read for a live sequence.
"""
from __future__ import annotations

import torch


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Number of blocks needed to hold ``n_tokens`` positions (>= 1)."""
    return max(1, -(-n_tokens // block_size))


def _flat_index(block_tables: torch.Tensor, positions: torch.Tensor,
                bs: int) -> torch.Tensor:
    blk = torch.gather(block_tables.long(), 1, (positions // bs).long())
    return (blk * bs + positions.long() % bs).reshape(-1)


def paged_update(pool: torch.Tensor, new: torch.Tensor,
                 block_tables: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """Scatter per-token state into the pool through the block table, in
    place.

    pool (nb, bs, *f); new (B, S, *f); block_tables (B, max_blocks) int32;
    positions (B, S) absolute positions.  Returns ``pool`` itself."""
    nb, bs = pool.shape[:2]
    flat = pool.view((nb * bs,) + tuple(pool.shape[2:]))
    idx = _flat_index(block_tables, positions, bs)
    flat.index_put_((idx,), new.reshape((-1,) + tuple(new.shape[2:]))
                    .to(pool.dtype))
    return pool


def paged_view(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Gather each sequence's blocks into a contiguous per-sequence view.

    pool (nb, bs, *f) + tables (B, max_blocks) -> (B, max_blocks*bs, *f),
    view index == absolute position.  Copies the whole padded view; only
    the ``impl="ref"`` oracle calls it."""
    B, mb = block_tables.shape
    bs = pool.shape[1]
    v = pool[block_tables.long()]                        # (B, mb, bs, *f)
    return v.reshape((B, mb * bs) + tuple(pool.shape[2:]))


def copy_block(leaf: torch.Tensor, src: int, dst: int, *,
               axis: int = 0) -> torch.Tensor:
    """Copy ONE block ``src`` -> ``dst`` along a pool leaf's block axis, in
    place (the copy-on-write fork primitive).  ``axis`` is 0 for flat
    leaves (nb, bs, *f) and 1 for layer-stacked leaves (L, nb, bs, *f)."""
    if axis == 0:
        leaf[dst].copy_(leaf[src])
    else:
        leaf[:, dst].copy_(leaf[:, src])
    return leaf


def copy_block_strided(leaf: torch.Tensor, src: int, dst: int,
                       stride: int) -> torch.Tensor:
    """Copy block ``src`` -> ``dst`` in EVERY layer of a layer-major pool,
    in place: rows ``l*stride + src -> l*stride + dst`` for all layers ``l``
    (L·block_size rows, not the pool)."""
    L = leaf.shape[0] // stride
    base = torch.arange(L, device=leaf.device) * stride
    leaf.index_copy_(0, base + dst, leaf[base + src])
    return leaf
