"""Whisper-style encoder-decoder (family ``audio``).

Port of ``repro.models.encdec``.  The mel-spectrogram + conv frontend is a
STUB, as in the reference: the model takes precomputed frame embeddings
(B, encoder_seq_len, d_model).  The encoder is a stack of bidirectional
self-attention layers (K9, not causal, RoPE over the frame positions, as
the reference's ``gqa_qkv`` applies it); the decoder a causal
self-attention (K9 without a cache, ``dense_attention`` over a contiguous
cache) + cross-attention (K9, not causal, Sq != Sk, in training, prefill
and decode) + MLP stack.  The loss runs K10.

``mesh`` (on ``hidden``, ``loss``, ``prefill``, ``decode_step``) is the
reference's keyword, a mesh or None; the model has no MoE layer, and the
reference's activation constraints read it (``constrain_batch`` on the
encoder's and the decoder's input and after each of their layers): they
redistribute placed activations on a mesh of more than one rank and are
identities otherwise.

Layout differences from the reference:

* parameters live in one ``EncLayer`` / ``DecLayer`` module per layer (the
  reference stacks each leaf on a leading ``layers`` axis for its scan;
  the weight bridge unstacks), and the layer loops are Python loops;
* the cache keeps the reference's layout: ``self`` {"k", "v"} (L, B, T,
  KVH, dh) and ``enc_out`` (B, F, D); it is updated IN PLACE, and
  ``prefill`` / ``decode_step`` return the cache object they were given.

As in the reference, every decoder layer projects the whole encoder output
to its cross K/V again at every call (``_cross_kv``), decode steps
included; the cache keeps ``enc_out``, not the projections.  Unlike the
reference, ``hidden`` encodes ``frontend_embeds`` whenever they are given:
the reference reads the cache's ``enc_out`` whenever the cache has that
key, which its own ``init_cache`` always gives, so its ``prefill`` on a
fresh cache attends zeros instead of the frames.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.attention import (GQA, apply_gqa, flash_attend,
                                          gqa_qkv)
from repro_torch.layers.common import (MLP, Embedding, _empty, embed,
                                       logits_from_hidden, rmsnorm,
                                       unembed_matrix)
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.models.transformer import param_axes  # noqa: F401
from repro_torch.sharding.rules import constrain_batch, split_dim

ENC_POS_SCALE = 0.02        # the reference's explicit ``scale=`` of enc_pos


def check_supported(cfg: ModelConfig) -> None:
    """Raise for every config this model cannot run as the reference does."""
    if cfg.family != "audio":
        raise NotImplementedError(f"the encoder-decoder serves family "
                                  f"'audio', got {cfg.family!r}")
    if cfg.encoder_layers <= 0 or cfg.encoder_seq_len <= 0:
        raise ValueError(f"encoder of {cfg.encoder_layers} layers over "
                         f"{cfg.encoder_seq_len} frames")
    if cfg.attention_type != "gqa" or cfg.dsa is not None \
            or cfg.num_experts > 0:
        raise NotImplementedError("the encoder-decoder runs dense GQA "
                                  "layers with dense MLPs, as the reference")


class EncLayer(nn.Module):
    """Pre-norm bidirectional self-attention + MLP."""

    AXES = {"attn_norm": ("embed",), "mlp_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _empty(cfg.d_model, **kw)
        self.attn = GQA(cfg, **kw)
        self.mlp_norm = _empty(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)


class DecLayer(nn.Module):
    """Pre-norm causal self-attention, cross-attention over the encoder
    output, MLP."""

    AXES = {"attn_norm": ("embed",), "cross_norm": ("embed",),
            "mlp_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attn_norm = _empty(cfg.d_model, **kw)
        self.attn = GQA(cfg, **kw)
        self.cross_norm = _empty(cfg.d_model, **kw)
        self.cross = GQA(cfg, **kw)
        self.mlp_norm = _empty(cfg.d_model, **kw)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.mlp_activation, **kw)


class EncDecModel(nn.Module):
    """Parameters of the encoder-decoder; ``forward(tokens,
    frontend_embeds)`` gives logits."""

    AXES = {"enc_pos": ("seq", "embed"), "enc_final_norm": ("embed",),
            "final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.enc_pos = _empty(cfg.encoder_seq_len, cfg.d_model, **kw)
        self.encoder = nn.ModuleList(EncLayer(cfg, **kw)
                                     for _ in range(cfg.encoder_layers))
        self.decoder = nn.ModuleList(DecLayer(cfg, **kw)
                                     for _ in range(cfg.num_layers))
        self.enc_final_norm = _empty(cfg.d_model, **kw)
        self.final_norm = _empty(cfg.d_model, **kw)

    def forward(self, tokens: torch.Tensor,
                frontend_embeds: torch.Tensor) -> torch.Tensor:
        return logits(self, tokens, frontend_embeds=frontend_embeds)


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, dtype=torch.float32) -> EncDecModel:
    """Random model with the reference's scales: the embedding normal * 1,
    ``enc_pos`` normal * 0.02, every other matrix normal * shape[0]^-1/2,
    norms at 1.  ``generator`` must live on ``device``; by default one
    seeded with 0 is made there.  Carry JAX weights over with
    ``repro_torch.bridge.from_jax_params``."""
    dev = resolve_device(device)
    model = EncDecModel(cfg, device=dev, dtype=dtype)
    if dev.type == "meta":       # the abstract init: shapes and dtypes
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim == 1:
                p.fill_(1.0)
                continue
            scale = {"embedding": 1.0, "enc_pos": ENC_POS_SCALE}.get(
                leaf, p.shape[0] ** -0.5)
            p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale)
    return model


def encode(model: EncDecModel, frame_embeds: torch.Tensor, *,
           mesh=None) -> torch.Tensor:
    """frame_embeds (B, F, D) -> encoder output (B, F, D)."""
    cfg = model.cfg
    B, F, _ = frame_embeds.shape
    h = constrain_batch(frame_embeds.to(model.enc_pos.dtype)
                        + model.enc_pos[None, :F], mesh)
    positions = torch.arange(F, device=h.device).expand(B, F)
    for lp in model.encoder:
        x = rmsnorm(h, lp.attn_norm, cfg.norm_eps)
        q, k, v = gqa_qkv(lp.attn, x, cfg, positions)
        o = flash_attend(q, k, v, causal=False, q_chunk=cfg.q_chunk)
        h = h + o.reshape(B, F, -1) @ lp.attn.wo
        x = rmsnorm(h, lp.mlp_norm, cfg.norm_eps)
        h = constrain_batch(h + lp.mlp(x), mesh)
    return rmsnorm(h, model.enc_final_norm, cfg.norm_eps)


def _cross_kv(lp: DecLayer, enc_out: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    B, F, _ = enc_out.shape
    KVH, dh = cfg.num_kv_heads, cfg.head_dim
    k = split_dim(enc_out @ lp.cross.wk, 2, (KVH, dh))
    v = split_dim(enc_out @ lp.cross.wv, 2, (KVH, dh))
    return k, v


def decoder_hidden(model: EncDecModel, tokens: torch.Tensor,
                   enc_out: torch.Tensor, *, cache: Optional[dict] = None,
                   cache_index: Optional[int] = None,
                   mesh=None) -> torch.Tensor:
    """Final-normed decoder hidden (B, S, D) of ``tokens`` at positions
    ``cache_index`` (default 0) onwards; with a cache, layer i's self K/V
    are written into ``cache["self"]`` index i in place."""
    cfg = model.cfg
    B, S = tokens.shape
    h = constrain_batch(embed(model.embed, tokens, cfg), mesh)
    start = int(cache_index or 0)
    positions = (torch.arange(S, device=h.device) + start).expand(B, S)
    for i, lp in enumerate(model.decoder):
        c = None if cache is None else \
            {name: leaf[i] for name, leaf in cache["self"].items()}
        x = rmsnorm(h, lp.attn_norm, cfg.norm_eps)
        o, _ = apply_gqa(lp.attn, x, cfg, positions=positions, cache=c,
                         cache_index=start)
        h = h + o
        x = rmsnorm(h, lp.cross_norm, cfg.norm_eps)
        o, _ = apply_gqa(lp.cross, x, cfg, positions=positions,
                         cross_kv=_cross_kv(lp, enc_out, cfg))
        h = h + o
        x = rmsnorm(h, lp.mlp_norm, cfg.norm_eps)
        h = constrain_batch(h + lp.mlp(x), mesh)
    return rmsnorm(h, model.final_norm, cfg.norm_eps)


def hidden(model: EncDecModel, tokens: torch.Tensor, *,
           frontend_embeds: Optional[torch.Tensor] = None,
           cache: Optional[dict] = None, cache_index=None, mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (final-normed decoder hidden (B, S, D), aux loss 0, cache).

    ``frontend_embeds`` (B, F, D) are encoded when given (and, with a
    cache, the encoder output is stored in ``cache["enc_out"]`` in place);
    without them the cache's ``enc_out`` is read."""
    if frontend_embeds is not None:
        enc_out = encode(model, frontend_embeds, mesh=mesh)
        if cache is not None:
            cache["enc_out"].copy_(enc_out)
    elif cache is not None:
        enc_out = cache["enc_out"]
    else:
        raise ValueError("the encoder-decoder needs frontend_embeds or a "
                         "cache holding enc_out")
    h = decoder_hidden(model, tokens, enc_out, cache=cache,
                       cache_index=cache_index, mesh=mesh)
    return h, h.new_zeros((), dtype=torch.float32), cache


def logits(model: EncDecModel, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full-vocab logits for every decoder position."""
    h, _, _ = hidden(model, tokens, **kw)
    return logits_from_hidden(model.embed, h, model.cfg)


def loss(model: EncDecModel, batch: Dict[str, torch.Tensor], *, mesh=None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss``: ``batch`` holds ``tokens``, ``targets``
    (B, S), ``frontend_embeds`` (B, F, D) and optionally ``loss_mask``;
    the masked mean token NLL (K10, no softcap, as the reference) with
    ``aux`` 0."""
    cfg = model.cfg
    targets = batch["targets"]
    h, aux, _ = hidden(model, batch["tokens"],
                       frontend_embeds=batch["frontend_embeds"], mesh=mesh)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    ce_sum, count = chunked_softmax_xent(
        h, unembed_matrix(model.embed, cfg), targets, mask,
        chunk=cfg.loss_chunk)
    total = ce_sum / count.clamp_min(1.0)
    return total, {"ce": total, "loss": total, "aux": aux}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """``self`` {"k", "v"} (L, B, T, KVH, dh) and ``enc_out`` (B, F, D),
    zeros."""
    dev = resolve_device(device)
    kv = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"self": {"k": torch.zeros(kv, dtype=dtype, device=dev),
                     "v": torch.zeros(kv, dtype=dtype, device=dev)},
            "enc_out": torch.zeros((batch, cfg.encoder_seq_len, cfg.d_model),
                                   dtype=dtype, device=dev)}


@torch.no_grad()
def prefill(model: EncDecModel, tokens: torch.Tensor, cache: dict, *,
            frontend_embeds: torch.Tensor, mesh=None
            ) -> Tuple[torch.Tensor, dict]:
    """Encode the frames, fill the self-attention cache with the prompt
    from position 0; returns (the last position's logits (B, 1, V),
    cache)."""
    h, _, cache = hidden(model, tokens, frontend_embeds=frontend_embeds,
                         cache=cache, cache_index=0, mesh=mesh)
    return logits_from_hidden(model.embed, h[:, -1:], model.cfg), cache


@torch.no_grad()
def decode_step(model: EncDecModel, token: torch.Tensor, cache: dict,
                cache_index: int, *, mesh=None) -> Tuple[torch.Tensor, dict]:
    """token (B, 1) at position ``cache_index`` -> (logits (B, 1, V),
    cache)."""
    h, _, cache = hidden(model, token, cache=cache, cache_index=cache_index,
                         mesh=mesh)
    return logits_from_hidden(model.embed, h, model.cfg), cache
