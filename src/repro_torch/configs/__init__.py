"""Architecture config registry, trimmed to what the port serves.

``get_config(arch_id)`` returns the full published config,
``get_smoke_config(arch_id)`` the reduced same-family variant.  Both
registered models carry the reference's DSA retrofit; the port serves them
with ``.replace(dsa=None)`` (the DSA slice is not ported yet, and the
model constructors reject a config that sets it).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DSAConfig, MLAConfig, MTPConfig,
                                      ModelConfig)

ARCH_IDS = ["gemma2_2b", "yi_6b"]

_ALIASES = {"gemma2-2b": "gemma2_2b", "yi-6b": "yi_6b"}


def canonical(arch_id: str) -> str:
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown or not yet ported arch {arch_id!r}; "
                       f"the port has: {ARCH_IDS}")
    return arch_id


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "canonical", "get_config", "get_smoke_config",
           "DSAConfig", "MLAConfig", "MTPConfig", "ModelConfig"]
