"""Architecture config registry: the reference's eleven architectures.

``get_config(arch_id)`` returns the full published config,
``get_smoke_config(arch_id)`` the reduced same-family variant.  Every
model but whisper carries the reference's DSA retrofit, which the port
serves; GLM-5 also carries its MTP head, which the port trains and drafts
speculative tokens with (``serving.speculative``,
``ContinuousEngine(spec_steps=...)``).  ``falcon_mamba_7b`` is the
attention-free Mamba-1 LM (family ``ssm``), served by the static
``ServingEngine`` and trained; ``zamba2_2p7b`` the hybrid family (Mamba-2
layers and one shared attention block), served by both engines;
``phi3_vision_4b`` (family ``vlm``) the transformer fed patch embeddings
before its text; ``whisper_base`` (family ``audio``) the encoder-decoder
of ``models.encdec``, served through ``launch.steps``'s prefill and serve
steps.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DSAConfig, MLAConfig, MTPConfig,
                                      ModelConfig)

ARCH_IDS = [
    "gemma2_2b",
    "phi3_vision_4b",
    "yi_6b",
    "minitron_4b",
    "whisper_base",
    "nemotron4_15b",
    "falcon_mamba_7b",
    "kimi_k2_1t",
    "qwen3_moe_235b",
    "zamba2_2p7b",
    "glm5_744b",   # the paper's own model
]

_ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "phi-3-vision-4.2b": "phi3_vision_4b",
    "yi-6b": "yi_6b",
    "minitron-4b": "minitron_4b",
    "whisper-base": "whisper_base",
    "nemotron-4-15b": "nemotron4_15b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "zamba2-2.7b": "zamba2_2p7b",
    "glm-5": "glm5_744b",
}


def canonical(arch_id: str) -> str:
    arch_id = _ALIASES.get(arch_id, arch_id)
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return arch_id


def _module(arch_id: str):
    return importlib.import_module(f"repro_torch.configs.{canonical(arch_id)}")


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


__all__ = ["ARCH_IDS", "canonical", "get_config", "get_smoke_config",
           "DSAConfig", "MLAConfig", "MTPConfig", "ModelConfig"]
