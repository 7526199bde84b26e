"""Model registry: family -> implementation module (port of
``repro.models.registry``: every family of the reference).

Every module implements the same interface (the model is an
``nn.Module`` holding the parameters, first argument of each function):
``init(cfg, generator, device, dtype)``, ``hidden``, ``loss(model,
batch)``, ``logits``, ``init_cache(cfg, batch, max_len, dtype, device)``,
``prefill(model, tokens, cache)``, ``decode_step(model, token, cache,
cache_index)`` and ``param_axes(model)``.  The transformer and the hybrid
also have the paged cache of the continuous-batching engine (the hybrid's
``init_paged_cache`` takes the engine's slots as ``batch``).  The
encoder-decoder (``audio``) has the contiguous cache only, and its
``prefill`` takes the frame embeddings (``frontend_embeds``).
"""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, ssm_model, transformer

_FAMILY = {"dense": transformer, "moe": transformer, "vlm": transformer,
           "audio": encdec, "ssm": ssm_model, "hybrid": hybrid}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r}: the port has {sorted(_FAMILY)}"
        ) from None
