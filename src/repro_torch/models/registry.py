"""Model registry: family -> implementation module (port of
``repro.models.registry``, trimmed to the families the port has)."""
from __future__ import annotations

from types import ModuleType

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer

_FAMILY = {"dense": transformer}


def get_model(cfg: ModelConfig) -> ModuleType:
    try:
        return _FAMILY[cfg.family]
    except KeyError:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port has "
            f"{sorted(_FAMILY)}") from None
