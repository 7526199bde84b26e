"""DSA — DeepSeek Sparse Attention, as adopted by GLM-5 (§2.1.1, §3.2).

Port of ``repro.core.dsa`` with both selectors and both top-k forms
(deterministic and randomized), for serving and training.  Three parts:

1. **Lightning indexer** — for query token t and key token s,
   ``I[t,s] = Σ_h w_h(x_t) · ReLU(q_h(x_t) · k(x_s)) · Di^-1/2``: the key
   projection is shared across indexer heads, the head weights ``w_h`` are
   query-dependent (a softmax).  Over the paged ``k_idx`` pool the scores
   come from K5 (a decode step) and K6 (a span), in place; over contiguous
   keys (no cache, the contiguous cache, the gathered view) from K7,
   differentiable through a plain backward.
2. **Top-k token selection** (k = 2048).  The reference uses
   ``jax.lax.top_k``, which puts the lower index first on ties;
   ``torch.topk`` promises no order.  Ties are common here (a key scores
   exactly 0 when every head's dot product is <= 0, and every masked
   position is exactly ``NEG_INF``), so ``select_topk`` sorts with a stable
   sort: equal scores keep index order, and the selection is the
   reference's element for element (GLM-5 §3.2: deterministic top-k was
   necessary for RL stability).
3. **Sparse attention** over the selected tokens, gathered one by one
   (``paged_take`` straight from the block pool on the paged paths).

The block selector (``selector="block"``, the reference's TPU adaptation)
pools the indexer scores over 128-query and 128-key blocks and keeps the
top ``top_k // block_size`` key blocks per query block
(``select_topk_blocks``); ``sparse_block_attention`` attends them through
K8 (``kernels.sparse_attention``), differentiable through a plain
backward.  ``dsa_attention`` takes that branch where the reference does
(its chunking decides it, see there); a decode step keeps the token
selector (``dsa_decode_paged``), as in the reference.

Training (``dsa_attention(with_indexer_loss=True)``) adds the indexer's KL
to the head-mean sparse attention over the selected support: the top-k
indices carry no gradient, so this term is the only gradient path into the
indexer (GLM-5 §2.1.1).  The block branch's term is the reference's
``-mean(log_softmax)`` of the scores of every selected block's tokens.

Randomized top-k (``deterministic_topk=False``, the RL-determinism study
of GLM-5 §3.2: a non-deterministic top-k kernel broke RL) adds uniform
noise in [0, 1e-6) to the masked token scores before the selection, as
the reference does, so exact ties break at random.  ``topk_noise`` draws
it from a generator seeded with the same fixed seed at every call: the
reference passes a fixed ``jax.random.key(0)`` at every call site, so one
shape always draws the same noise.  The draws follow the reference's
shapes: (B, 1, T) a decode step, one (B, S, T) over a paged span (sliced
for each of its chunks here), and in ``dsa_attention`` one (B, S, T)
where the reference takes the queries in one block or the same (B,
q_chunk, T) for every chunk where it scans them.  The block selector
takes no noise.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DSAConfig, ModelConfig
from repro_torch.core.paging import paged_take
from repro_torch.kernels.lightning_indexer import ops as li_ops
from repro_torch.kernels.paged_attention.ops import (paged_indexer_prefill,
                                                     paged_indexer_scores)
from repro_torch.kernels.sparse_attention import kernel as sparse_kernel
from repro_torch.layers.attention import NEG_INF, attention_mask
from repro_torch.layers.common import _empty

W_HEAD_SCALE = 0.02     # the reference's init scale of ``w_head``
Q_CHUNK = 256           # query rows per gather (see ``_by_query_chunks``)
TOPK_NOISE_SEED = 0     # every call draws from this seed (the fixed key)
TOPK_NOISE_MAX = 1e-6   # the noise is uniform in [0, TOPK_NOISE_MAX)


# ---------------------------------------------------------------------------
# indexer
# ---------------------------------------------------------------------------

class Indexer(nn.Module):
    """Lightning-indexer weights of one layer, (in, out) layout, under the
    reference's names (``build_indexer``)."""

    AXES = {"wq_idx": ("embed_fsdp", "index_heads"),
            "wk_idx": ("embed_fsdp", None), "w_head": ("embed", None)}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        d, D = cfg.dsa, cfg.d_model
        kw = dict(device=device, dtype=dtype)
        self.wq_idx = _empty(D, d.index_heads * d.index_head_dim, **kw)
        self.wk_idx = _empty(D, d.index_head_dim, **kw)
        self.w_head = _empty(D, d.index_heads, **kw)


def indexer_keys(idx: Indexer, x_kv: torch.Tensor) -> torch.Tensor:
    """x_kv (B, T, D) -> k_idx (B, T, Di); cached for decode."""
    return x_kv @ idx.wk_idx


def indexer_queries(idx: Indexer, x_q: torch.Tensor, dsa: DSAConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_q (B, S, D) -> (q_idx (B, S, Hi, Di) in the model's dtype, head
    weights (B, S, Hi) fp32, softmaxed)."""
    B, S, _ = x_q.shape
    q = (x_q @ idx.wq_idx).reshape(B, S, dsa.index_heads, dsa.index_head_dim)
    w = torch.softmax((x_q @ idx.w_head).float(), dim=-1)
    return q, w


def indexer_scores(idx: Indexer, x_q: torch.Tensor, k_idx: torch.Tensor,
                   dsa: DSAConfig) -> torch.Tensor:
    """x_q (B, S, D), k_idx (B, T, Di) -> scores (B, S, T) fp32: K7 on CUDA
    tensors, its plain version on CPU ones; differentiable."""
    q, w = indexer_queries(idx, x_q, dsa)
    return li_ops.indexer_scores(q, w, k_idx)


def indexer_distill_loss(scores: torch.Tensor, attn_probs: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Warm-up loss: KL(attn || softmax(scores)) per query, averaged over
    the queries with any valid key.  ``attn_probs`` (B, S, T) is the
    head-mean dense attention of the frozen base model; ``mask`` (B, S, T)
    the causal validity mask."""
    logp = torch.log_softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    p = torch.where(mask, attn_probs, 0.0)
    kl = (p * (torch.log(p.clamp_min(1e-20)) - logp)).sum(-1)
    rows = mask.any(-1)
    return torch.where(rows, kl, 0.0).sum() / rows.sum().clamp_min(1)


# ---------------------------------------------------------------------------
# top-k selection
# ---------------------------------------------------------------------------

def topk_noise(shape: Tuple[int, ...], device) -> torch.Tensor:
    """The randomized top-k's noise: fp32 uniform in [0, 1e-6) of
    ``shape`` on ``device``, from a generator on that device seeded with
    ``TOPK_NOISE_SEED`` at every call, so a shape always draws the same
    values (the reference's fixed key).  Every caller looks it up on this
    module at call time."""
    gen = torch.Generator(device=device).manual_seed(TOPK_NOISE_SEED)
    return torch.rand(shape, generator=gen, device=device) * TOPK_NOISE_MAX


def select_topk(scores: torch.Tensor, mask: torch.Tensor, k: int,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scores (B, S, T) + validity mask -> (idx (B, S, k) int64, valid
    (B, S, k)).  A stable descending sort keeps equal scores in index
    order, so ties break by the lower index as ``jax.lax.top_k`` does.
    ``noise`` (B, S, T) (``topk_noise``; None: deterministic) is added to
    the valid scores first."""
    k = min(k, scores.shape[-1])
    masked = torch.where(mask, scores if noise is None else scores + noise,
                         NEG_INF)
    vals, idx = torch.sort(masked, dim=-1, descending=True, stable=True)
    return idx[..., :k], vals[..., :k] > NEG_INF / 2


def select_topk_blocks(scores: torch.Tensor, mask: torch.Tensor, k: int,
                       block_size: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-granular selection (the reference's TPU adaptation).

    scores/mask (B, S, T), S and T multiples of ``block_size``.  Per
    (query block, key block): the max of the masked scores plus half their
    mean; the top ``k // block_size`` key blocks of each query block,
    ties by the lower index (a stable sort, as ``select_topk``).  Returns
    (block_idx (B, S/bs, nb) int32, valid).

    The reference takes that mean in fp32 over scores where masked entries
    are NEG_INF = -2e38: two of them already sum past the fp32 range, so
    the mean of a key block with two or more masked entries is -inf, in any
    order of summation, and the block ranks below even the wholly masked
    blocks (NEG_INF) and is never valid: no diagonal block is ever chosen
    (ROADMAP queue 3).  The mean is computed here in that closed form, not
    left to the accumulator precision of ``torch.mean``."""
    B, S, T = scores.shape
    qb = kb = block_size
    nqb, nkb = S // qb, T // kb
    m = mask.reshape(B, nqb, qb, nkb, kb)
    s = torch.where(m, scores.reshape(m.shape), NEG_INF)
    pooled_max = s.amax(dim=(2, 4))
    n_masked = (~m).sum(dim=(2, 4))
    total = torch.where(m, s, 0.0).sum(dim=(2, 4)) + n_masked * NEG_INF
    pooled_mean = torch.where(n_masked >= 2, -torch.inf, total / (qb * kb))
    pooled = pooled_max + 0.5 * pooled_mean               # (B, nqb, nkb)
    pooled = torch.where(m.any(dim=(2, 4)), pooled, NEG_INF)
    nb = min(max(1, k // kb), nkb)
    vals, idx = torch.sort(pooled, dim=-1, descending=True, stable=True)
    return idx[..., :nb].to(torch.int32), vals[..., :nb] > NEG_INF / 2


# ---------------------------------------------------------------------------
# sparse attention cores
# ---------------------------------------------------------------------------

def _gather_tokens(kv: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """kv (B, T, KVH, d), idx (B, S, K) -> (B, S, K, KVH, d)."""
    B, T = kv.shape[:2]
    flat = kv.reshape(B, T, -1)
    rows = torch.arange(B, device=kv.device)[:, None]
    sel = flat[rows, idx.reshape(B, -1).long()]           # (B, S*K, KVH*d)
    return sel.reshape(idx.shape + tuple(kv.shape[2:]))


def _attend_selected(q: torch.Tensor, k_sel: torch.Tensor,
                     v_sel: torch.Tensor, ok: torch.Tensor, *,
                     softcap: float = 0.0, return_probs: bool = False):
    """Attention over an already-gathered token selection: q (B, S, H, dh);
    k_sel/v_sel (B, S, K, KVH, d*); ok (B, S, K) -> (B, S, H, dv), and with
    ``return_probs`` also the head-mean probabilities (B, S, K).  fp32
    scores and softmax; the probabilities meet V in V's dtype, as in the
    reference."""
    B, S, H, dh = q.shape
    KVH = k_sel.shape[3]
    qg = q.reshape(B, S, KVH, H // KVH, dh)
    scores = torch.einsum("bsjgd,bskjd->bsjgk", qg.float(),
                          k_sel.float()) * (dh ** -0.5)
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(ok[:, :, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bsjgk,bskjd->bsjgd", probs.to(v_sel.dtype), v_sel)
    if return_probs:
        return out.reshape(B, S, H, -1), probs.mean(dim=(2, 3))
    return out.reshape(B, S, H, -1)


def sparse_token_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           idx: torch.Tensor, valid: torch.Tensor,
                           q_positions: torch.Tensor,
                           kv_positions: torch.Tensor, *,
                           softcap: float = 0.0, return_probs: bool = False):
    """Per-token gathered attention: q (B, S, H, dh); k/v (B, T, KVH, d*);
    idx/valid (B, S, K).  The selected positions are checked against
    causality again (the guard keeps the op safe under padding).  With
    ``return_probs`` also the head-mean probabilities (B, S, K)."""
    B = q.shape[0]
    k_sel = _gather_tokens(k, idx)
    v_sel = _gather_tokens(v, idx)
    sel_pos = torch.gather(kv_positions.long(), 1,
                           idx.reshape(B, -1).long()).reshape(idx.shape)
    ok = valid & (sel_pos <= q_positions[..., None])
    return _attend_selected(q, k_sel, v_sel, ok, softcap=softcap,
                            return_probs=return_probs)


class _SparseBlockAttend(torch.autograd.Function):
    """K8 forward; the backward recomputes K8's plain version and
    differentiates it (the reference has no backward kernel: JAX
    differentiates its XLA ``sparse_block_attention``)."""

    @staticmethod
    def forward(ctx, q, k, v, block_idx, q_start, block_size, softcap):
        ctx.save_for_backward(q, k, v, block_idx, q_start)
        ctx.block_size, ctx.softcap = block_size, softcap
        return sparse_kernel.block_sparse_attention(
            q, k, v, block_idx, q_start, block_size=block_size,
            softcap=softcap, empty_mean=True)

    @staticmethod
    def backward(ctx, g):
        q, k, v, block_idx, q_start = ctx.saved_tensors
        with torch.enable_grad():
            qd, kd, vd = (t.detach().requires_grad_() for t in (q, k, v))
            out = sparse_kernel.block_sparse_attention_plain(
                qd, kd, vd, block_idx, q_start, block_size=ctx.block_size,
                softcap=ctx.softcap, empty_mean=True)
            dq, dk, dv = torch.autograd.grad(out, (qd, kd, vd), g)
        return dq, dk, dv, None, None, None, None


def sparse_block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           block_idx: torch.Tensor, block_valid: torch.Tensor,
                           q_positions: torch.Tensor, block_size: int, *,
                           softcap: float = 0.0) -> torch.Tensor:
    """Block-gathered attention: every query block attends its selected
    key blocks (dense within a block), through K8.

    q (B, S, H, dqk); k (B, T, KVH, dqk), v (B, T, KVH, dv), key j at
    position j (every caller's keys: no cache, the contiguous cache, the
    gathered view); block_idx/block_valid (B, S/bs, nb) from
    ``select_topk_blocks``; q_positions (B, S) ascending by one from each
    row's start.  A query attends the keys of its block's valid blocks at
    or before its position; one that sees none gets the mean of V over all
    the selected blocks' tokens, as the reference's softmax over scores
    that are all NEG_INF does.  Differentiable in q, k and v."""
    ids = block_idx.to(torch.int32)
    ids = torch.where(block_valid, ids, -ids - 1).contiguous()
    q_start = q_positions[:, 0].to(torch.int32).contiguous()
    return _SparseBlockAttend.apply(q.contiguous(), k.contiguous(),
                                    v.contiguous(), ids, q_start, block_size,
                                    softcap)


def _by_query_chunks(fn: Callable[[int, int], torch.Tensor], S: int,
                     chunk: int) -> torch.Tensor:
    """``fn(lo, hi)`` over query rows [lo, hi) in chunks of ``chunk``,
    concatenated along the query axis.  Each query row's selection and
    attention depend on that row alone, so chunking changes no result; it
    bounds the gathered (rows, k, KVH, d) K/V, which at Yi-6B width and
    k = 2048 is ~1 GB in fp32 for 256 rows."""
    if S <= chunk:
        return fn(0, S)
    return torch.cat([fn(lo, min(lo + chunk, S)) for lo in range(0, S, chunk)],
                     dim=1)


def dsa_decode_paged(idx: Indexer, q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, x_q: torch.Tensor,
                     ki_pool: torch.Tensor, block_tables: torch.Tensor,
                     seq_lens: torch.Tensor, q_positions: torch.Tensor,
                     cfg: ModelConfig, *, softcap: float = 0.0,
                     impl: str = "kernel") -> torch.Tensor:
    """One-token DSA decode straight off the block pool (no gathered view).

    The indexer scores the ``k_idx`` pool in place (K5; ``impl="ref"``: the
    gather oracle); the top-k indices come back in view coordinates (==
    absolute positions) and go through the block table (``paged_take``),
    so only k tokens are gathered.  q (B, 1, H, dh); pools (nb, bs, ·);
    x_q (B, 1, D) the pre-projection hiddens; seq_lens (B,) the query
    positions; q_positions (B, 1)."""
    dsa = cfg.dsa
    B = q.shape[0]
    q_idx, w = indexer_queries(idx, x_q, dsa)
    scores = paged_indexer_scores(q_idx[:, 0], w[:, 0], ki_pool,
                                  block_tables, seq_lens, impl=impl)
    T = scores.shape[1]
    kv_positions = torch.arange(T, device=q.device).expand(B, T)
    mask = attention_mask(q_positions, kv_positions, causal=True)
    noise = None if dsa.deterministic_topk \
        else topk_noise((B, 1, T), scores.device)
    sel, valid = select_topk(scores[:, None], mask, dsa.top_k,
                             noise)                         # (B, 1, K)
    k_sel = paged_take(k_pool, block_tables, sel[:, 0])[:, None]
    v_sel = paged_take(v_pool, block_tables, sel[:, 0])[:, None]
    # view index == absolute position: the selected indices ARE positions
    ok = valid & (sel <= q_positions[..., None])
    return _attend_selected(q, k_sel, v_sel, ok, softcap=softcap)


def dsa_prefill_paged(idx: Indexer, q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, x_q: torch.Tensor,
                      ki_pool: torch.Tensor, block_tables: torch.Tensor,
                      positions: torch.Tensor, cfg: ModelConfig, *,
                      window: int = 0, softcap: float = 0.0,
                      impl: str = "kernel",
                      q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Span DSA prefill straight off the block pool: the span twin of
    ``dsa_decode_paged``.  The indexer scores the whole span against the
    ``k_idx`` pool in place (K6, once), then each chunk of ``q_chunk``
    queries selects its top-k and gathers only those tokens.

    q (B, S, H, dh); x_q (B, S, D); positions (B, S) absolute, ascending
    from a per-row start."""
    dsa = cfg.dsa
    B, S = q.shape[:2]
    q_idx, w = indexer_queries(idx, x_q, dsa)
    scores = paged_indexer_prefill(q_idx, w, ki_pool, block_tables,
                                   positions[:, 0], impl=impl)  # (B, S, T)
    T = scores.shape[-1]
    kv_positions = torch.arange(T, device=q.device).expand(B, T)
    # one draw over the whole span, as the reference's, sliced a chunk at
    # a time (a fresh draw a chunk would give other values)
    noise = None if dsa.deterministic_topk \
        else topk_noise((B, S, T), scores.device)

    def chunk(lo: int, hi: int) -> torch.Tensor:
        pos = positions[:, lo:hi]
        mask = attention_mask(pos, kv_positions, causal=True, window=window)
        sel, valid = select_topk(scores[:, lo:hi], mask, dsa.top_k,
                                 None if noise is None else noise[:, lo:hi])
        K = sel.shape[-1]
        k_sel = paged_take(k_pool, block_tables, sel.reshape(B, -1))
        v_sel = paged_take(v_pool, block_tables, sel.reshape(B, -1))
        k_sel = k_sel.reshape((B, hi - lo, K) + tuple(k_sel.shape[2:]))
        v_sel = v_sel.reshape((B, hi - lo, K) + tuple(v_sel.shape[2:]))
        # view index == absolute position: the selected indices ARE positions
        ok = valid & (sel <= pos[..., None])
        if window > 0:
            ok &= (pos[..., None] - sel) < window
        return _attend_selected(q[:, lo:hi], k_sel, v_sel, ok,
                                softcap=softcap)

    return _by_query_chunks(chunk, S, q_chunk)


def dsa_attention(idx: Indexer, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, x_q: torch.Tensor, k_idx: torch.Tensor,
                  q_positions: torch.Tensor, kv_positions: torch.Tensor,
                  cfg: ModelConfig, *, kv_len: Optional[int] = None,
                  window: int = 0, softcap: float = 0.0,
                  q_chunk: int = Q_CHUNK, with_indexer_loss: bool = False):
    """End-to-end sparse attention over dense K/V (no cache, the contiguous
    cache of the static oracle, the gathered view of ``impl="ref"``):
    indexer scores -> top-k -> gathered attention, ``q_chunk`` query rows
    at a time (the last chunk ragged; the reference chunks only when
    ``S % q_chunk == 0``, which gives the same result).

    q (B, S, H, dh); k/v (B, T, KVH, d*); x_q (B, S, D) the pre-projection
    hiddens; k_idx (B, T, Di).

    With ``with_indexer_loss=True`` (the model without a cache, as in the
    reference) it also returns the indexer KL over the selected support,
    KL(head-mean sparse attention, detached || softmax(indexer
    scores[selected])), averaged over the B·S queries.  The reference
    averages each chunk's queries, then the chunks (equal in size), or
    takes one block when ``S % q_chunk``: the same mean.  Each chunk is
    recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so one chunk's gathered K/V is live at
    a time; the recompute runs the indexer scores again.

    With the block selector the reference's rule decides the branch: it
    chunks only when S is a multiple of ``q_chunk`` (else one chunk of all
    S queries), and a chunk takes the block branch when S >= block_size
    and both the chunk and T are multiples of block_size; otherwise the
    token branch, as above (S = 300 with blocks of 128: tokens; S = 384:
    one block-branch chunk of three query blocks)."""
    dsa = cfg.dsa
    B, S = q.shape[:2]
    if dsa.selector == "block":
        step = q_chunk if 0 < q_chunk < S and S % q_chunk == 0 else S
        bs = dsa.block_size
        if S >= bs and k.shape[1] % bs == 0 and step % bs == 0:
            return _dsa_blocks(idx, q, k, v, x_q, k_idx, q_positions,
                               kv_positions, cfg, kv_len, window, softcap,
                               step, with_indexer_loss)

    noise_at = _chunk_noise(dsa, B, S, k.shape[1], q_chunk, q.device)

    def chunk(q_c, xq_c, pos, noise):
        scores = indexer_scores(idx, xq_c, k_idx, dsa)
        mask = attention_mask(pos, kv_positions, causal=True, window=window,
                              kv_len=kv_len)
        sel, valid = select_topk(scores.detach(), mask, dsa.top_k, noise)
        if not with_indexer_loss:
            return sparse_token_attention(q_c, k, v, sel, valid, pos,
                                          kv_positions, softcap=softcap)
        out, tprobs = sparse_token_attention(
            q_c, k, v, sel, valid, pos, kv_positions, softcap=softcap,
            return_probs=True)
        ind_logp = torch.log_softmax(
            torch.where(valid, torch.gather(scores, -1, sel), NEG_INF), -1)
        t = torch.where(valid, tprobs, 0.0).detach()
        kl = (t * (torch.log(t.clamp_min(1e-20)) - ind_logp)).sum(-1)
        return out, kl.sum()

    if not with_indexer_loss:
        return _by_query_chunks(
            lambda lo, hi: chunk(q[:, lo:hi], x_q[:, lo:hi],
                                 q_positions[:, lo:hi], noise_at(lo, hi)),
            S, q_chunk)
    step = q_chunk if q_chunk > 0 else S
    outs, kl_sum = [], 0.0
    for lo in range(0, S, step):
        sl = slice(lo, lo + step)
        out, kl = checkpoint(chunk, q[:, sl], x_q[:, sl], q_positions[:, sl],
                             noise_at(lo, min(lo + step, S)),
                             use_reentrant=False)
        outs.append(out)
        kl_sum = kl_sum + kl
    return torch.cat(outs, dim=1), kl_sum / (B * S)


def _chunk_noise(dsa: DSAConfig, B: int, S: int, T: int, q_chunk: int,
                 device) -> Callable[[int, int], Optional[torch.Tensor]]:
    """``dsa_attention``'s top-k noise for query rows [lo, hi) (None with
    the deterministic top-k).  Where S is a multiple of ``q_chunk`` (and
    larger) the reference scans chunks of ``q_chunk`` rows and draws (B,
    q_chunk, T) inside the scan: the same values for every chunk.
    Otherwise it takes the queries in one block and draws (B, S, T) once,
    which is sliced here for each of this function's chunks."""
    if dsa.deterministic_topk:
        return lambda lo, hi: None
    if 0 < q_chunk < S and S % q_chunk == 0:
        noise = topk_noise((B, q_chunk, T), device)
        return lambda lo, hi: noise
    noise = topk_noise((B, S, T), device)
    return lambda lo, hi: noise[:, lo:hi]


def _dsa_blocks(idx: Indexer, q, k, v, x_q, k_idx, q_positions,
                kv_positions, cfg: ModelConfig, kv_len, window: int,
                softcap: float, step: int, with_indexer_loss: bool):
    """The block branch of ``dsa_attention`` over query chunks of ``step``
    rows: indexer scores -> ``select_topk_blocks`` -> K8.  With the loss,
    each chunk's is the reference's ``-mean(log_softmax)`` of the scores of
    the tokens of its query blocks' selected blocks (no validity or causal
    mask: which invalid blocks the top-k order picks changes it), and the
    result the mean over the chunks; each chunk is recomputed in the
    backward (``torch.utils.checkpoint``), so K8 runs twice a chunk."""
    dsa = cfg.dsa
    bs = dsa.block_size
    B, S = q.shape[:2]
    offs = torch.arange(bs, device=q.device)

    def chunk(q_c, xq_c, pos):
        scores = indexer_scores(idx, xq_c, k_idx, dsa)
        mask = attention_mask(pos, kv_positions, causal=True, window=window,
                              kv_len=kv_len)
        bidx, bval = select_topk_blocks(scores.detach(), mask, dsa.top_k, bs)
        out = sparse_block_attention(q_c, k, v, bidx, bval, pos, bs,
                                     softcap=softcap)
        if not with_indexer_loss:
            return out
        tok = (bidx.long()[..., None] * bs + offs).reshape(
            B, bidx.shape[1], -1).repeat_interleave(bs, dim=1)
        ind_logp = torch.log_softmax(torch.gather(scores, -1, tok), dim=-1)
        return out, -ind_logp.mean()

    outs, kls = [], []
    for lo in range(0, S, step):
        sl = slice(lo, lo + step)
        args = (q[:, sl], x_q[:, sl], q_positions[:, sl])
        if with_indexer_loss:
            out, kl = checkpoint(chunk, *args, use_reentrant=False)
            kls.append(kl)
        else:
            out = chunk(*args)
        outs.append(out)
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return (out, torch.stack(kls).mean()) if with_indexer_loss else out
