"""Decoder-only transformer: the dense, MoE and VLM families of the
reference.

Port of ``repro.models.transformer`` for configurations the port serves
exactly as the reference does: GQA or MLA attention, DSA sparse attention
on the ``global`` layers (the lightning indexer, deterministic or
randomized top-k, the token or the block selector), dense MLP (swiglu /
relu2 / gelu) or routed MoE FFN (the pattern layers, after
``first_k_dense`` dense-MLP layers), the ``attention_pattern`` layer
groups (local sliding-window / global),
attention and final logit softcaps, tied (gemma-scaled) embeddings,
``qk_norm``, the MTP head (``core.mtp``: one shared non-MoE ``global``
block; under DSA it has an indexer, and runs dense, ``sparse=False``, as
in the reference) and the VLM family's stubbed frontend: ``hidden``,
``loss`` and ``prefill`` take ``frontend_embeds`` (B, F, D), precomputed
patch embeddings put before the text's token embeddings, positions
running over all F + S rows (the loss reads the text rows only).  DSA
takes either top-k: deterministic or randomized (``deterministic_topk=
False``, ``core.dsa.topk_noise``).  A config that needs a part not ported
yet — another family, another attention type — raises
``NotImplementedError`` instead of quietly running without it.

``sparse`` (on ``hidden``, ``apply_block``, ``verify_step``, ``loss``;
default ``cfg.dsa is not None``, the reference's) switches a layer's DSA
indexer on or off: with ``sparse=False`` a GQA layer attends densely and
writes no indexer keys, an MLA layer still writes them into its cache.

Training: ``loss(model, batch)`` is the reference's ``loss``: the chunked
cross-entropy (K10) plus the auxiliary losses that ``hidden`` sums over
the layers (the MoE router's load-balance loss and 0.01 × the DSA indexer
KL), plus 0.3 × the MTP losses when the config has the head.  Without a
cache a GQA layer attends through K9 (``layers.attention.flash_attend``),
a DSA layer scores through K7 and, with the block selector, attends
through K8; ``param_axes`` gives every parameter the logical axes its
reference ``b.param`` call declares, which Muon and the sharding rules
read.  With ``cfg.remat="full"`` the training forward keeps only every
``remat_group``-th pattern group's input and recomputes the groups in
the backward (``torch.utils.checkpoint``; one group at a time where
``remat_group`` does not divide the groups, as the reference): the values
are the same, the peak memory lower.

``mesh`` (on ``hidden``, ``loss``, ``prefill``, ``decode_step``,
``verify_step``) is the reference's: it reaches the MoE layers, whose
``apply_moe`` chooses the expert-parallel path by it; the reference's
activation constraints are identities on the one rank the port runs.

Layout differences from the reference:

* parameters live in one ``Block`` module per layer (the reference stacks
  each pattern slot on a leading ``n_groups`` axis for ``lax.scan``; the
  weight bridge unstacks), and the layer loop is a Python loop;
* caches keep the reference's layout exactly: GQA layers hold ``k``/``v``
  leaves, MLA layers the latent ``c`` (kv_lora) and ``kr`` (rope) leaves,
  and a DSA layer also the indexer keys ``k_idx``;
  ``init_cache`` stacks each slot as ``(n_groups, B, T, *f)``,
  ``init_paged_cache`` builds the LAYER-MAJOR flat pools
  ``(n_groups*num_blocks, bs, *f)`` that group ``g`` addresses with
  ``block_tables + g*num_blocks``, so pools and block tables compare one to
  one with the reference's;
* caches are updated IN PLACE (the reference donates them to its jits);
  ``prefill`` / ``decode_step`` return the same cache object they were
  given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dsa as dsa_mod
from repro_torch.core import mla as mla_mod
from repro_torch.core import mtp as mtp_mod
from repro_torch.core.paging import paged_update, paged_view
from repro_torch.device import resolve_device
from repro_torch.kernels.paged_attention.ops import (paged_gqa_attend,
                                                     paged_gqa_prefill)
from repro_torch.layers.attention import (GQA, dense_attention,
                                          flash_attend, gqa_qkv)
from repro_torch.layers.common import (MLP, Embedding, _empty, embed,
                                       logits_from_hidden, rmsnorm,
                                       unembed_matrix)
from repro_torch.layers.moe import ROUTER_SCALE, MoE, apply_moe
from repro_torch.models.losses import chunked_softmax_xent, mean_xent

NORMS = ("attn_norm", "mlp_norm", "final_norm", "q_norm", "k_norm",
         "q_a_norm", "kv_a_norm", "h_norm", "e_norm")
FAMILIES = ("dense", "moe", "vlm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every config this slice cannot serve as the reference does."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (the port serves "
            f"{FAMILIES})")
    if cfg.dsa is not None and cfg.dsa.selector not in ("token", "block"):
        raise ValueError(f"DSA selector {cfg.dsa.selector!r}: the reference "
                         f"has 'token' and 'block'")
    if cfg.attention_type not in ("gqa", "mla"):
        raise NotImplementedError(
            f"attention_type {cfg.attention_type!r} is not ported")
    if cfg.attention_type == "mla" and cfg.mla is None:
        raise ValueError("attention_type='mla' needs cfg.mla")
    if cfg.num_experts > 0 and not (
            0 < cfg.experts_per_token <= cfg.num_experts
            and cfg.moe_d_ff > 0):
        raise ValueError(f"MoE config: top-{cfg.experts_per_token} of "
                         f"{cfg.num_experts} experts, moe_d_ff "
                         f"{cfg.moe_d_ff}")
    P = len(cfg.attention_pattern)
    if (cfg.num_layers - cfg.first_k_dense) % P:
        raise ValueError(f"{cfg.num_layers - cfg.first_k_dense} pattern "
                         f"layers do not tile the pattern {cfg.attention_pattern}")


def layer_kind(cfg: ModelConfig, i: int) -> str:
    if i < cfg.first_k_dense:
        return "global"
    pattern = cfg.attention_pattern
    return pattern[(i - cfg.first_k_dense) % len(pattern)]


def n_groups(cfg: ModelConfig) -> int:
    return (cfg.num_layers - cfg.first_k_dense) // len(cfg.attention_pattern)


class Block(nn.Module):
    """One decoder layer: pre-norm attention (GQA or MLA, with a DSA
    indexer ``idx`` on the global layers of a DSA config) + pre-norm FFN
    (MLP, or MoE in the pattern layers of an MoE config)."""

    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, kind: str, moe: bool, *,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.kind = kind
        self.attn_norm = _empty(cfg.d_model, **kw)
        self.attn = mla_mod.MLA(cfg, **kw) if cfg.attention_type == "mla" \
            else GQA(cfg, **kw)
        if cfg.dsa is not None and kind == "global":
            self.idx = dsa_mod.Indexer(cfg, **kw)
        self.mlp_norm = _empty(cfg.d_model, **kw)
        if moe:
            self.moe = MoE(cfg, **kw)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)


class Transformer(nn.Module):
    """Parameters of the whole decoder (and the MTP head ``mtp`` when the
    config has one); ``forward(tokens)`` gives logits."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, layer_kind(cfg, i),
                  cfg.num_experts > 0 and i >= cfg.first_k_dense, **kw)
            for i in range(cfg.num_layers))
        self.final_norm = _empty(cfg.d_model, **kw)
        if cfg.mtp is not None:
            self.mtp = mtp_mod.MTP(
                cfg, lambda: Block(cfg, "global", False, **kw), **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return logits(self, tokens)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, dtype=torch.float32) -> Transformer:
    """Random model with the reference's scales (``sharding/rules.py``):
    tensors normal * shape[0]^-1/2 (the input dim of a matrix; the expert
    count of a stacked (E, in, out) expert tensor, as the reference's
    builder computes it), the embedding normal * 1.0, the MoE router and
    the DSA head weights ``w_head`` normal * 0.02 (their explicit
    ``scale=``), norms at 1.  Expert tensors are drawn one expert at a
    time, so no fp32 temporary the size of a whole (E, D, F) tensor is
    made.  ``generator`` must live on
    ``device``; by default one seeded with 0 is made there.  The numbers
    differ from the reference's (a ``jax.random`` key is not a torch
    generator): carry JAX weights over with
    ``repro_torch.bridge.from_jax_params``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev, dtype=dtype)
    if dev.type == "meta":       # the abstract init: shapes and dtypes
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in NORMS:
                p.fill_(1.0)
                continue
            scale = {"embedding": 1.0, "router": ROUTER_SCALE,
                     "w_head": dsa_mod.W_HEAD_SCALE}.get(
                leaf, p.shape[0] ** -0.5)
            for part in (p.unbind(0) if p.ndim == 3 else (p,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=dev, dtype=torch.float32)
                           * scale)
    return model


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _cache_index_keys(idx: dsa_mod.Indexer, h: torch.Tensor, layer_cache,
                      cache_index, block_tables: Optional[torch.Tensor],
                      positions: torch.Tensor) -> torch.Tensor:
    """Write this layer's indexer keys into its ``k_idx`` leaf (paged:
    through the table at ``positions``; contiguous: at ``cache_index``),
    in place; returns the leaf."""
    ki = dsa_mod.indexer_keys(idx, h)
    leaf = layer_cache["k_idx"]
    if block_tables is not None:
        return paged_update(leaf, ki, block_tables, positions)
    leaf[:, cache_index:cache_index + ki.shape[1]] = ki.to(leaf.dtype)
    return leaf


def _attend_mla(block: Block, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, layer_cache, cache_index,
                block_tables: Optional[torch.Tensor],
                paged_impl: str, sparse: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLA branch of the reference's ``_attend``: MHA-style without a
    cache (sparse over the indexer's top-k on a DSA layer when ``sparse``,
    with the indexer KL; the block selector attends through K8), absorbed
    over the latent cache with one (paged: K3 for a step, K4 for a span).
    With a cache a DSA layer writes its indexer keys (``sparse`` or not)
    and reads none, as the reference does: its attention stays dense.
    Returns (out, indexer KL or 0)."""
    attn, idx = block.attn, getattr(block, "idx", None)
    B, S, _ = h.shape
    zero = h.new_zeros((), dtype=torch.float32)
    if layer_cache is None:
        if idx is None or not sparse:
            return mla_mod.apply_mla(attn, h, cfg, positions=positions), zero
        q, k, v, _, _ = mla_mod.mla_qkv(attn, h, cfg, positions)
        out, kl = dsa_mod.dsa_attention(
            idx, q, k, v, h, dsa_mod.indexer_keys(idx, h), positions,
            positions, cfg, q_chunk=min(cfg.q_chunk, 256),
            with_indexer_loss=True)
        return out.reshape(B, S, -1) @ attn.wo, kl
    if block_tables is not None:
        out, _, _ = mla_mod.mla_decode_paged(
            attn, h, cfg, c_pool=layer_cache["c"], kr_pool=layer_cache["kr"],
            block_tables=block_tables, positions=positions, impl=paged_impl)
    else:
        out, _, _ = mla_mod.mla_decode_absorbed(
            attn, h, cfg, c_cache=layer_cache["c"],
            kr_cache=layer_cache["kr"], cache_index=cache_index,
            positions=positions)
    if idx is not None:
        _cache_index_keys(idx, h, layer_cache, cache_index, block_tables,
                          positions)
    return out, zero


def _attend(block: Block, h: torch.Tensor, cfg: ModelConfig,
            positions: torch.Tensor, layer_cache, cache_index,
            block_tables: Optional[torch.Tensor],
            paged_impl: str, sparse: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention sub-layer on normed hidden h; returns (out, indexer KL):
    the KL of a DSA layer without a cache, 0 otherwise.  A GQA layer uses
    its indexer only when ``sparse``.

    ``layer_cache`` is None (no cache), this layer's dict of contiguous
    (B, T, *f) leaves, or, with ``block_tables`` (this layer's table,
    already offset into the layer-major pool), the dict of flat pools.
    Paged single-token steps read the cache in place through K1 (GQA) / K3
    (MLA), spans through K2 / K4; a GQA layer with DSA scores its indexer
    keys in place through K5 (a step) / K6 (a span) and attends the top-k
    tokens it gathers through the table.  ``paged_impl='ref'`` is the
    gather oracle: a span gathers the padded view (DSA: then
    ``dsa_attention`` over it), a DSA step keeps ``dsa_decode_paged`` with
    the gathered indexer scores, as in the reference.  A span of a DSA
    layer with the block selector gathers the view on either route (the
    reference has no in-place span for it) and runs ``dsa_attention``: its
    block branch (K8) where the span and the view are multiples of the
    block size.  Without a cache the positions are 0..S-1 (``hidden`` makes
    them so): a layer without DSA runs K9, one with DSA the training form
    of ``dsa_attention`` (K7, the indexer KL; K8 with the block
    selector)."""
    if cfg.attention_type == "mla":
        return _attend_mla(block, h, cfg, positions, layer_cache, cache_index,
                           block_tables, paged_impl, sparse)
    attn = block.attn
    idx = getattr(block, "idx", None) if sparse else None
    q_chunk = min(cfg.q_chunk, 256)
    B, S, _ = h.shape
    window = cfg.sliding_window if block.kind == "local" else 0
    softcap = cfg.attn_logit_softcap
    q, k, v = gqa_qkv(attn, h, cfg, positions)
    kl = h.new_zeros((), dtype=torch.float32)
    if layer_cache is None:
        if idx is None:
            out = flash_attend(q, k, v, window=window, softcap=softcap,
                               q_chunk=cfg.q_chunk)
        else:
            out, kl = dsa_mod.dsa_attention(
                idx, q, k, v, h, dsa_mod.indexer_keys(idx, h), positions,
                positions, cfg, window=window, softcap=softcap,
                q_chunk=q_chunk, with_indexer_loss=True)
    elif block_tables is not None:
        k_pool, v_pool = layer_cache["k"], layer_cache["v"]
        paged_update(k_pool, k, block_tables, positions)
        paged_update(v_pool, v, block_tables, positions)
        if idx is None:
            attend = paged_gqa_attend if S == 1 else paged_gqa_prefill
            out = attend(q, k_pool, v_pool, block_tables, positions[:, 0],
                         window=window, softcap=softcap, impl=paged_impl)
        else:
            ki_pool = _cache_index_keys(idx, h, layer_cache, cache_index,
                                        block_tables, positions)
            if S == 1:
                out = dsa_mod.dsa_decode_paged(
                    idx, q, k_pool, v_pool, h, ki_pool, block_tables,
                    positions[:, 0], positions, cfg, softcap=softcap,
                    impl=paged_impl)
            elif paged_impl != "ref" and cfg.dsa.selector == "token":
                out = dsa_mod.dsa_prefill_paged(
                    idx, q, k_pool, v_pool, h, ki_pool, block_tables,
                    positions, cfg, window=window, softcap=softcap,
                    impl=paged_impl)
            else:      # the gathered view: index == position, no kv_len
                k_full = paged_view(k_pool, block_tables)
                T = k_full.shape[1]
                out = dsa_mod.dsa_attention(
                    idx, q, k_full, paged_view(v_pool, block_tables), h,
                    paged_view(ki_pool, block_tables), positions,
                    torch.arange(T, device=h.device).expand(B, T), cfg,
                    window=window, softcap=softcap, q_chunk=q_chunk)
    else:
        k_cache, v_cache = layer_cache["k"], layer_cache["v"]
        k_cache[:, cache_index:cache_index + S] = k.to(k_cache.dtype)
        v_cache[:, cache_index:cache_index + S] = v.to(v_cache.dtype)
        T = k_cache.shape[1]
        kv_positions = torch.arange(T, device=h.device).expand(B, T)
        if idx is None:
            out = dense_attention(q, k_cache, v_cache, positions,
                                  kv_positions, causal=True, window=window,
                                  softcap=softcap, kv_len=cache_index + S)
        else:
            ki_cache = _cache_index_keys(idx, h, layer_cache, cache_index,
                                         None, positions)
            out = dsa_mod.dsa_attention(
                idx, q, k_cache, v_cache, h, ki_cache, positions,
                kv_positions, cfg, kv_len=cache_index + S, window=window,
                softcap=softcap, q_chunk=q_chunk)
    return out.reshape(B, S, -1) @ attn.wo, kl


def apply_block(block: Block, h: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, *, sparse: bool = False,
                layer_cache=None, cache_index=None, block_tables=None,
                paged_impl: str = "kernel", mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (h, aux loss): the MoE router's load-balance loss plus 0.01 ×
    the indexer KL (the reference's coefficients)."""
    a_in = rmsnorm(h, block.attn_norm, cfg.norm_eps)
    a_out, ind_kl = _attend(block, a_in, cfg, positions, layer_cache,
                            cache_index, block_tables, paged_impl, sparse)
    h = h + a_out
    m_in = rmsnorm(h, block.mlp_norm, cfg.norm_eps)
    if hasattr(block, "moe"):
        m_out, aux = apply_moe(block.moe, m_in, cfg, mesh=mesh)
    else:
        m_out, aux = block.mlp(m_in), 0.0
    # indexer KL coefficient 0.01 (small; it only trains the indexer)
    return h + m_out, aux + 0.01 * ind_kl


def _layer_caches(cfg: ModelConfig, cache: dict, block_tables):
    """Per layer: (dict of cache leaves, block table) in layer order, for
    any leaf names (``k``/``v`` or ``c``/``kr``, and ``k_idx``).  Contiguous
    slot leaves are indexed at the layer's group; paged slot pools are
    layer-major: group g reads rows ``g*stride + table``."""
    P = len(cfg.attention_pattern)
    ng = n_groups(cfg)
    for i in range(cfg.num_layers):
        if i < cfg.first_k_dense:
            yield cache[f"dense_{i}"], block_tables
            continue
        g, j = divmod(i - cfg.first_k_dense, P)
        c = cache[f"slot{j}"]
        if block_tables is None:
            yield {name: leaf[g] for name, leaf in c.items()}, None
        else:
            stride = next(iter(c.values())).shape[0] // ng
            yield c, block_tables + g * stride


def _remat_span(cfg: ModelConfig) -> int:
    """Layers a checkpoint under ``remat="full"``: ``remat_group`` pattern
    groups, or one where that does not divide the groups."""
    R = cfg.remat_group if cfg.remat_group >= 1 \
        and n_groups(cfg) % cfg.remat_group == 0 else 1
    return R * len(cfg.attention_pattern)


def hidden(model: Transformer, tokens: torch.Tensor, *,
           frontend_embeds: Optional[torch.Tensor] = None,
           sparse: Optional[bool] = None, cache: Optional[dict] = None,
           cache_index=None, block_tables: Optional[torch.Tensor] = None,
           paged_impl: str = "kernel", mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (final-normed hidden (B, F + S, D), aux loss, cache).

    ``frontend_embeds`` (B, F, D), when given, are the first F rows of the
    sequence, before the S token embeddings (F = 0 without).  Positions
    start at ``cache_index``: with ``block_tables`` the cache is
    the paged block pool and ``cache_index`` the per-sequence start vector
    (B,); with a contiguous cache ``cache_index`` is the int offset of
    token 0; without a cache they are 0..S-1."""
    cfg = model.cfg
    if sparse is None:
        sparse = cfg.dsa is not None
    B = tokens.shape[0]
    dev = tokens.device
    h = embed(model.embed, tokens, cfg)
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    S = h.shape[1]
    span = torch.arange(S, dtype=torch.int32, device=dev)
    if isinstance(cache_index, torch.Tensor) and cache_index.ndim == 1:
        positions = cache_index.to(torch.int32)[:, None] + span[None]
    else:
        positions = (span + int(cache_index or 0)).expand(B, S)
    caches = _layer_caches(cfg, cache, block_tables) if cache is not None \
        else ((None, None) for _ in model.layers)
    layers = list(zip(model.layers, caches))

    def run(layers, h, aux):
        for block, (layer_cache, tables) in layers:
            h, a = apply_block(block, h, cfg, positions, sparse=sparse,
                               layer_cache=layer_cache,
                               cache_index=cache_index, block_tables=tables,
                               paged_impl=paged_impl, mesh=mesh)
            aux = aux + a
        return h, aux

    aux = h.new_zeros((), dtype=torch.float32)
    if cache is None and cfg.remat == "full" and torch.is_grad_enabled():
        # the first_k_dense layers as they are, then a non-reentrant
        # checkpoint a span of layer groups
        k, span = cfg.first_k_dense, _remat_span(cfg)
        h, aux = run(layers[:k], h, aux)
        for i in range(k, cfg.num_layers, span):
            h, aux = checkpoint(run, layers[i:i + span], h, aux,
                                use_reentrant=False)
    else:
        h, aux = run(layers, h, aux)
    return rmsnorm(h, model.final_norm, cfg.norm_eps), aux, cache


def logits(model: Transformer, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full-vocab logits for every position (no cache unless given)."""
    h, _, _ = hidden(model, tokens, **kw)
    return logits_from_hidden(model.embed, h, model.cfg)


def loss(model: Transformer, batch: Dict[str, torch.Tensor], *,
         sparse: Optional[bool] = None, mesh=None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss``: ``batch`` holds ``tokens`` and ``targets``
    (B, S) and optionally ``loss_mask`` (default ones) and
    ``frontend_embeds`` (B, F, D), whose rows the cross-entropy skips: it
    reads the hidden of the S text rows.  Returns (total,
    {"ce", "aux", "loss"} and "mtp" with the head): the masked mean token
    NLL (K10) plus the layers' auxiliary losses, plus 0.3 × the MTP losses
    (``core.mtp.mtp_train_losses``: each step's mean NLL over the masked-in
    positions that still have a target j tokens ahead, its block dense)."""
    cfg = model.cfg
    tokens, targets = batch["tokens"], batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    fe = batch.get("frontend_embeds")
    h, aux, _ = hidden(model, tokens, frontend_embeds=fe, sparse=sparse,
                       mesh=mesh)
    h = h[:, 0 if fe is None else fe.shape[1]:]
    W = unembed_matrix(model.embed, cfg)
    ce_sum, count = chunked_softmax_xent(
        h, W, targets, mask, chunk=cfg.loss_chunk,
        softcap=cfg.final_logit_softcap)
    ce = ce_sum / count.clamp_min(1.0)
    total = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp is not None:
        B, S = tokens.shape
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        mtp_loss = mtp_mod.mtp_train_losses(
            model.mtp, cfg, h, tokens, targets, positions,
            lambda t: embed(model.embed, t, cfg),
            lambda hh, tg, valid: mean_xent(
                hh, W, tg, mask * valid, chunk=cfg.loss_chunk,
                softcap=cfg.final_logit_softcap),
            lambda blk, x, pos: apply_block(blk, x, cfg, pos,
                                            sparse=False)[0])
        total = total + 0.3 * mtp_loss
        metrics["mtp"] = mtp_loss
    metrics["loss"] = total
    return total, metrics


def param_axes(model: nn.Module) -> Dict[str, Tuple[Optional[str], ...]]:
    """Every parameter's logical axes, by its name in
    ``model.named_parameters()``: the axes of its reference ``b.param``
    call (the port's counterpart of the Builder specs), without the leading
    ``layers`` axis of the reference's scanned groups (one ``Block`` per
    layer here; Muon treats leading axes as groups, so nothing changes)."""
    axes = {}
    for prefix, module in model.named_modules():
        for name, _ in module.named_parameters(recurse=False):
            axes[f"{prefix}.{name}" if prefix else name] = module.AXES[name]
    return axes


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def _layer_leaves(cfg: ModelConfig, lead: tuple, kind: str, dtype,
                  device) -> Dict[str, torch.Tensor]:
    """One layer's cache leaves with leading dims ``lead``: the latent
    ``c`` (kv_lora) and ``kr`` (rope) for MLA, ``k``/``v`` (KVH, d) for
    GQA, plus the indexer keys ``k_idx`` (index_head_dim) on a global layer
    of a DSA config."""
    if cfg.attention_type == "mla":
        m = cfg.mla
        feats = {"c": (m.kv_lora_dim,), "kr": (m.qk_rope_dim,)}
    else:
        f = (cfg.num_kv_heads, cfg.head_dim)
        feats = {"k": f, "v": f}
    if cfg.dsa is not None and kind == "global":
        feats["k_idx"] = (cfg.dsa.index_head_dim,)
    return {name: torch.zeros(lead + f, dtype=dtype, device=device)
            for name, f in feats.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """Contiguous cache: ``dense_i`` (B, T, *f) leaves and stacked
    ``slotJ`` (n_groups, B, T, *f) leaves, as the reference."""
    dev = resolve_device(device)
    cache = {f"dense_{i}": _layer_leaves(cfg, (batch, max_len), "global",
                                         dtype, dev)
             for i in range(cfg.first_k_dense)}
    for j, kind in enumerate(cfg.attention_pattern):
        cache[f"slot{j}"] = _layer_leaves(
            cfg, (n_groups(cfg), batch, max_len), kind, dtype, dev)
    return cache


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype=torch.float32, device=None) -> dict:
    """Block-pool cache: ``dense_i`` flat pools (num_blocks, bs, *f) and
    LAYER-MAJOR ``slotJ`` pools (n_groups*num_blocks, bs, *f); callers
    pass per-layer block ids in [0, num_blocks)."""
    dev = resolve_device(device)
    cache = {f"dense_{i}": _layer_leaves(cfg, (num_blocks, block_size),
                                         "global", dtype, dev)
             for i in range(cfg.first_k_dense)}
    for j, kind in enumerate(cfg.attention_pattern):
        cache[f"slot{j}"] = _layer_leaves(
            cfg, (n_groups(cfg) * num_blocks, block_size), kind, dtype, dev)
    return cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: dict, *,
            frontend_embeds: Optional[torch.Tensor] = None,
            block_tables: Optional[torch.Tensor] = None, cache_index=None,
            paged_impl: str = "kernel", mesh=None
            ) -> Tuple[torch.Tensor, dict]:
    """Fill the cache with the prompt (after ``frontend_embeds``' F rows,
    when given); returns (logits, cache).

    Paged mode (``block_tables`` set) returns ALL-position logits (B, F +
    S, V) — the caller picks its own last real position per sequence;
    contiguous mode returns the last position's (B, 1, V)."""
    h, _, cache = hidden(model, tokens, frontend_embeds=frontend_embeds,
                         cache=cache,
                         cache_index=0 if cache_index is None else cache_index,
                         block_tables=block_tables, paged_impl=paged_impl,
                         mesh=mesh)
    if block_tables is None:
        h = h[:, -1:]
    return logits_from_hidden(model.embed, h, model.cfg), cache


@torch.no_grad()
def verify_step(model: Transformer, tokens: torch.Tensor, cache: dict,
                seq_lens: torch.Tensor, *, sparse: Optional[bool] = None,
                block_tables: Optional[torch.Tensor] = None,
                paged_impl: str = "kernel", mesh=None
                ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Speculative verification: an S-token span at per-row starts
    ``seq_lens`` (B,) (token i of row b at position ``seq_lens[b] + i``),
    through the same paged span path as prefill; returns (logits (B, S, V),
    the final-normed hidden (B, S, D), cache).  ``logits[:, j]`` is the
    model's next-token distribution after token j (the accept test),
    ``hidden[:, j]`` the state the next MTP draft chains from.  Rejected
    positions are rolled back by the caller truncating its lengths."""
    h, _, cache = hidden(model, tokens, sparse=sparse, cache=cache,
                         cache_index=seq_lens, block_tables=block_tables,
                         paged_impl=paged_impl, mesh=mesh)
    return logits_from_hidden(model.embed, h, model.cfg), h, cache


@torch.no_grad()
def decode_step(model: Transformer, token: torch.Tensor, cache: dict,
                cache_index, *, block_tables: Optional[torch.Tensor] = None,
                paged_impl: str = "kernel", mesh=None
                ) -> Tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V), cache).  With ``block_tables``
    ``cache_index`` is the per-sequence length vector (B,)."""
    h, _, cache = hidden(model, token, cache=cache, cache_index=cache_index,
                         block_tables=block_tables, paged_impl=paged_impl,
                         mesh=mesh)
    return logits_from_hidden(model.embed, h, model.cfg), cache
