"""Model configuration dataclasses (the port's copy of ``repro.configs.base``).

``ModelConfig`` keeps the reference's fields that the port reads, with the
same names and defaults, plus the few that mark a part of a later slice
(``dsa``, ``mla``, ``mtp``, ``attention_type``, ``num_experts``,
``family``): the model constructors reject a config that sets one.  The
reference's MoE details, SSM / hybrid / encoder / frontend fields and its
implementation switches (``attn_impl``, ``scan_layers``, ``remat``, ...)
are left out, so a setting the port cannot honour fails when the config
is built instead of being ignored.  The training and workload dataclasses
are not needed by the serving slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DSAConfig:
    """DeepSeek Sparse Attention (GLM-5 §2.1.1).  The port does not serve
    it yet (the DSA slice); a config that sets it is rejected."""
    index_heads: int = 32
    index_head_dim: int = 128
    top_k: int = 2048
    selector: str = "token"
    block_size: int = 128
    deterministic_topk: bool = True
    warmup_freeze_base: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """Multi-latent attention dims (GLM-5 Table 10); MLA slice."""
    q_lora_dim: int = 2048
    kv_lora_dim: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 256


@dataclass(frozen=True)
class MTPConfig:
    """Multi-token prediction with parameter sharing (GLM-5 §2.1); MTP
    slice."""
    num_predict: int = 3
    share_params: bool = True


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio
    citation: str = ""

    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0              # 0 -> d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 1024
    max_seq_len: int = 8192
    rope_base: float = 10000.0
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # attention flavor
    attention_type: str = "gqa"    # gqa | mla
    attention_pattern: Tuple[str, ...] = ("global",)  # cycled over layers
    sliding_window: int = 0        # used by 'local' layers in the pattern
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    mlp_activation: str = "swiglu"  # swiglu | relu2 | gelu
    qk_norm: bool = False

    mla: Optional[MLAConfig] = None
    dsa: Optional[DSAConfig] = None
    mtp: Optional[MTPConfig] = None

    num_experts: int = 0           # MoE is a later slice; rejected when set
    first_k_dense: int = 0         # leading layers outside the pattern

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
