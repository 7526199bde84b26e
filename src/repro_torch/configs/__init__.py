"""Architecture config registry, trimmed to what the port serves.

``get_config(arch_id)`` returns the full published config,
``get_smoke_config(arch_id)`` the reduced same-family variant.  Every
registered model carries the reference's DSA retrofit, which the port
serves; GLM-5 also carries its MTP head, which the port trains and drafts
speculative tokens with (``serving.speculative``,
``ContinuousEngine(spec_steps=...)``).  ``falcon_mamba_7b`` is the
attention-free Mamba-1 LM (family ``ssm``), served by the static
``ServingEngine`` and trained; ``zamba2_2p7b`` the hybrid family (Mamba-2
layers and one shared attention block), served by both engines.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DSAConfig, MLAConfig, MTPConfig,
                                      ModelConfig)

ARCH_IDS = ["falcon_mamba_7b", "gemma2_2b", "glm5_744b", "yi_6b",
            "zamba2_2p7b"]

_ALIASES = {"falcon-mamba-7b": "falcon_mamba_7b",
            "gemma2-2b": "gemma2_2b", "glm-5": "glm5_744b",
            "glm-5-744b": "glm5_744b",
            "yi-6b": "yi_6b", "zamba2-2.7b": "zamba2_2p7b"}


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
