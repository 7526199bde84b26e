"""Attention-free Mamba-1 LM (falcon-mamba-7b), family ``ssm``.

Port of ``repro.models.ssm_model``, with the registry's interface: each
layer is a pre-norm Mamba-1 mixer with a residual (``layers.ssm``, the
scan through K11), then a final norm; the loss is the chunked
cross-entropy alone (K10; no softcap, no auxiliary loss); the "cache" is
the per-layer recurrent state, length-free.

``mesh`` (on ``hidden``, ``loss``, ``prefill``, ``decode_step``) is the
reference's keyword, a mesh or None; the model has no MoE layer, and the
reference's activation constraints read it (``constrain_batch`` after the
embedding and after each layer): they redistribute placed activations on
a mesh of more than one rank and are identities otherwise.

Layout differences from the reference:

* parameters live in one ``Layer`` module per layer (the reference stacks
  them on a leading ``layers`` axis for ``lax.scan``; the weight bridge
  unstacks), and the layer loop is a Python loop;
* the state keeps the reference's layout, ``conv`` (L, B, W-1, E) and
  ``ssm`` (L, B, E, N) in the dtype it was made in, and is updated IN
  PLACE (the reference returns new arrays): ``prefill`` and
  ``decode_step`` return the cache object they were given.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.layers.common import (Embedding, _empty, embed,
                                       logits_from_hidden, rmsnorm,
                                       unembed_matrix)
from repro_torch.layers.ssm import Mamba1, apply_mamba1, mamba1_state
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.models.transformer import param_axes  # noqa: F401
from repro_torch.sharding.rules import constrain_batch


def check_supported(cfg: ModelConfig) -> None:
    if cfg.family != "ssm":
        raise NotImplementedError(f"the ssm model serves family 'ssm', got "
                                  f"{cfg.family!r}")
    if cfg.ssm_version != 1:
        raise NotImplementedError(
            f"ssm_version {cfg.ssm_version}: the port runs Mamba-2 layers in "
            f"the hybrid family (models.hybrid), not in the ssm model")
    if cfg.ssm_state <= 0:
        raise ValueError(f"ssm_state must be positive, got {cfg.ssm_state}")


class Layer(nn.Module):
    """One pre-norm Mamba-1 block with a residual."""

    AXES = {"norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None):
        super().__init__()
        self.norm = _empty(cfg.d_model, device=device, dtype=dtype)
        self.mamba = Mamba1(cfg, device=device, dtype=dtype)


class SSMModel(nn.Module):
    """Parameters of the whole LM; ``forward(tokens)`` gives logits."""

    AXES = {"final_norm": ("embed",)}

    def __init__(self, cfg: ModelConfig, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        check_supported(cfg)
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        self.embed = Embedding(cfg, **kw)
        self.layers = nn.ModuleList(Layer(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = _empty(cfg.d_model, **kw)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return logits(self, tokens)


def init(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
         device=None, dtype=torch.float32) -> SSMModel:
    """Random model with the reference's scales: the embedding normal * 1,
    the unembedding normal * d_model^-1/2, norms at 1, and each mixer's
    own (``Mamba1.reset_parameters``).  ``generator`` must live on
    ``device``; by default one seeded with 0 is made there.  Carry JAX
    weights over with ``repro_torch.bridge.from_jax_params``."""
    dev = resolve_device(device)
    model = SSMModel(cfg, device=dev, dtype=dtype)
    if dev.type == "meta":       # the abstract init: shapes and dtypes
        return model
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for name, p in model.embed.named_parameters():
            scale = 1.0 if name == "embedding" else p.shape[0] ** -0.5
            p.copy_(torch.randn(p.shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale)
        for layer in model.layers:
            layer.norm.fill_(1.0)
            layer.mamba.reset_parameters(generator)
        model.final_norm.fill_(1.0)
    return model


def hidden(model: SSMModel, tokens: torch.Tensor, *,
           cache: Optional[dict] = None, mesh=None
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[dict]]:
    """Returns (final-normed hidden (B, S, D), aux loss 0, cache).  With a
    cache (``init_cache``) each layer starts from its state and writes the
    new one into it in place."""
    cfg = model.cfg
    h = constrain_batch(embed(model.embed, tokens, cfg), mesh)
    for i, layer in enumerate(model.layers):
        st = None if cache is None else \
            {"conv": cache["conv"][i], "ssm": cache["ssm"][i]}
        x = rmsnorm(h, layer.norm, cfg.norm_eps)
        y, new = apply_mamba1(layer.mamba, x, cfg, state=st)
        h = constrain_batch(h + y, mesh)
        if cache is not None:
            cache["conv"][i].copy_(new["conv"])
            cache["ssm"][i].copy_(new["ssm"])
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    return h, h.new_zeros((), dtype=torch.float32), cache


def loss(model: SSMModel, batch: Dict[str, torch.Tensor], *, mesh=None
         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``loss``: the masked mean token NLL (K10) over
    ``tokens`` / ``targets`` (B, S) and ``loss_mask`` (default ones);
    returns (total, {"ce", "loss", "aux"})."""
    cfg = model.cfg
    targets = batch["targets"]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
    h, aux, _ = hidden(model, batch["tokens"], mesh=mesh)
    ce_sum, count = chunked_softmax_xent(
        h, unembed_matrix(model.embed, cfg), targets, mask,
        chunk=cfg.loss_chunk)
    total = ce_sum / count.clamp_min(1.0)
    return total, {"ce": total, "loss": total, "aux": aux}


def logits(model: SSMModel, tokens: torch.Tensor, **kw) -> torch.Tensor:
    """Full-vocab logits for every position (no cache unless given)."""
    h, _, _ = hidden(model, tokens, **kw)
    return logits_from_hidden(model.embed, h, model.cfg)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.float32, device=None) -> dict:
    """The stacked per-layer recurrent state, zeros: ``conv`` (L, B, W-1, E)
    and ``ssm`` (L, B, E, N); ``max_len`` is the registry's argument (the
    state is length-free)."""
    one = mamba1_state(cfg, batch, dtype, resolve_device(device))
    return {k: v.expand(cfg.num_layers, *v.shape).contiguous()
            for k, v in one.items()}


@torch.no_grad()
def prefill(model: SSMModel, tokens: torch.Tensor, cache: dict, *,
            mesh=None) -> Tuple[torch.Tensor, dict]:
    """Run the prompt through the state; returns (last position's logits
    (B, 1, V), cache)."""
    h, _, cache = hidden(model, tokens, cache=cache, mesh=mesh)
    return logits_from_hidden(model.embed, h[:, -1:], model.cfg), cache


@torch.no_grad()
def decode_step(model: SSMModel, token: torch.Tensor, cache: dict,
                cache_index=None, *, mesh=None) -> Tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V), cache).  ``cache_index`` is the
    registry's argument: the state carries the position."""
    h, _, cache = hidden(model, token, cache=cache, mesh=mesh)
    return logits_from_hidden(model.embed, h, model.cfg), cache
