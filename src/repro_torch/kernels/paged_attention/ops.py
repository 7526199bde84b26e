"""Dispatch for paged attention: in-place block reads vs gather.

Port of the reference's ``kernels/paged_attention/ops.py`` (GQA, MLA and
DSA-indexer parts).  The model calls these with its own layout, q
(B, S, H, ·) — GQA head ``h = kvh*G + g`` — and they pack the queries the
way the kernels take them.

``impl`` takes two values:

* ``"kernel"`` (default) — read KV blocks in place: K1 (GQA) / K3 (MLA)
  for a decode step, K2 / K4 for a span; the DSA indexer scores through K5
  (a step) / K6 (a span).  The tensor's device decides how: a CUDA tensor
  launches the hand-written kernel (or raises), a CPU tensor runs the
  kernel's plain PyTorch version.  No switch puts the plain version on the
  card.
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


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where it is contiguous: a decode step's wrappers are
    host-bound, and ``.contiguous()`` costs a dispatch even when it copies
    nothing."""
    return x if x.is_contiguous() else x.contiguous()


def _int32(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous int32 tensor, itself where it is one already."""
    return _dense(x if x.dtype == torch.int32 else x.to(torch.int32))


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


def paged_mla_attend(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     c_pool: torch.Tensor, kr_pool: torch.Tensor,
                     block_tables: torch.Tensor, seq_lens: torch.Tensor, *,
                     scale: float, impl: str = "kernel") -> torch.Tensor:
    """Absorbed MLA decode ``probs · c`` over the paged latent cache.

    q_lat/q_rope (B, 1, H, ·) -> out_lat (B, 1, H, lora) fp32; the caller
    applies W^UV / W^O (see ``repro_torch.core.mla.mla_decode_paged``)."""
    if check_impl(impl) == "ref":
        return _ref.paged_mla_reference(q_lat, q_rope, c_pool, kr_pool,
                                        block_tables, seq_lens, scale=scale)
    out = _k.paged_decode_mla(_dense(q_lat[:, 0]), _dense(q_rope[:, 0]),
                              c_pool, kr_pool, block_tables,
                              _int32(seq_lens), scale=scale)
    return out[:, None]


def paged_mla_prefill(q_lat: torch.Tensor, q_rope: torch.Tensor,
                      c_pool: torch.Tensor, kr_pool: torch.Tensor,
                      block_tables: torch.Tensor, starts: torch.Tensor, *,
                      scale: float, impl: str = "kernel") -> torch.Tensor:
    """Absorbed MLA span prefill ``probs · c`` over the paged latent cache.

    q_lat/q_rope (B, S, H, ·) -> out_lat (B, S, H, lora) fp32; packed rows
    ``i*H + h`` as the reference packs them."""
    if check_impl(impl) == "ref":
        return _ref.paged_mla_prefill_reference(
            q_lat, q_rope, c_pool, kr_pool, block_tables, starts,
            scale=scale)
    B, S, H, L = q_lat.shape
    out = _p.paged_prefill_mla(
        q_lat.reshape(B, S * H, L).contiguous(),
        q_rope.reshape(B, S * H, q_rope.shape[-1]).contiguous(),
        c_pool, kr_pool, block_tables, starts.to(torch.int32).contiguous(),
        heads=H, scale=scale)
    return out.reshape(B, S, H, L)


def paged_indexer_scores(q_idx: torch.Tensor, w_head: torch.Tensor,
                         k_pool: torch.Tensor, block_tables: torch.Tensor,
                         seq_lens: torch.Tensor, *,
                         impl: str = "kernel") -> torch.Tensor:
    """DSA decode indexer scores in view coordinates (B, mb*bs) fp32.

    q_idx (B, Hi, Di); w_head (B, Hi) softmaxed; k_pool (nb, bs, Di).
    Blocks past each row's query score NEG_INF in place (K5) and stale
    values under ``ref``: the selector's causal mask excludes both, so the
    top-k is the same."""
    if check_impl(impl) == "ref":
        return _ref.paged_indexer_reference(q_idx, w_head, k_pool,
                                            block_tables, seq_lens)
    if w_head.dtype != torch.float32:
        w_head = w_head.float()
    return _k.paged_indexer_scores_kernel(
        _dense(q_idx), _dense(w_head), k_pool, block_tables,
        _int32(seq_lens))


def paged_indexer_prefill(q_idx: torch.Tensor, w_head: torch.Tensor,
                          k_pool: torch.Tensor, block_tables: torch.Tensor,
                          starts: torch.Tensor, *,
                          impl: str = "kernel") -> torch.Tensor:
    """DSA span indexer scores in view coordinates (B, S, mb*bs) fp32.

    q_idx (B, S, Hi, Di); w_head (B, S, Hi) softmaxed; packed rows
    ``i*Hi + h`` for K6 as the reference packs them."""
    if check_impl(impl) == "ref":
        return _ref.paged_indexer_prefill_reference(q_idx, w_head, k_pool,
                                                    block_tables, starts)
    B, S, Hi, Di = q_idx.shape
    return _p.paged_prefill_indexer(
        q_idx.reshape(B, S * Hi, Di).contiguous(),
        w_head.reshape(B, S * Hi).float().contiguous(), k_pool, block_tables,
        starts.to(torch.int32).contiguous(), heads=Hi)
