"""Model configuration dataclasses (the port's copy of ``repro.configs.base``).

``ModelConfig`` keeps the reference's fields that the port reads, with the
same names and defaults.  ``dsa`` is served with either selector and
either top-k (deterministic or randomized), ``mtp`` with its shared head;
family ``ssm`` is the Mamba-1 LM (``models.ssm_model``: ``ssm_state``,
``ssm_conv``, ``ssm_expand``), family ``hybrid`` the zamba2-style model
(``models.hybrid``: Mamba-2 layers, ``ssm_version=2`` with heads of
``ssm_head_dim``, and one shared attention block every
``hybrid_attn_every`` layers), family ``vlm`` the transformer fed
``frontend_tokens`` precomputed patch embeddings before its text
(``frontend='vision_stub'``), family ``audio`` the Whisper-style
encoder-decoder (``models.encdec``: ``encoder_layers`` bidirectional
layers over ``encoder_seq_len`` precomputed frame embeddings,
``frontend='audio_stub'``).  ``moe_impl`` picks the MoE path
(``layers.moe.apply_moe``: ``auto``, ``dense`` or ``expert_parallel``,
with ``capacity_factor`` bounding an expert's tokens on the latter);
``remat`` (``none`` or ``full``) and ``remat_group`` checkpoint the
transformer's layer groups in training; ``seq_parallel`` is the
reference's sequence sharding of the residual stream: a step takes a mesh
of one rank at most, where that sharding and the batch sharding it
replaces are both identities, so either value is honoured and no layer
reads it.  The reference's unread ``decoder_max_len`` and its XLA switches
(``attn_impl``, ``scan_layers``) are left out, so a setting the port
cannot honour fails when the config is built instead of being ignored.
``q_chunk`` and ``loss_chunk`` bound the training path's transient memory
(attention's backward and DSA chunks; the cross-entropy's backward) and
change no value.  ``TrainConfig`` is the reference's less ``optimizer``
and ``min_lr``, which its trainer never reads: the trainer always steps
Muon (Split unless ``muon_split`` is off) and floors the cosine at a
tenth of the peak.  ``INPUT_SHAPES`` are the reference's four workload
shapes, which the dry run and the roofline read.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DSAConfig:
    """DeepSeek Sparse Attention (GLM-5 §2.1.1): a lightning indexer
    scores every cached token, the top ``top_k`` are attended (``token``)
    or the top ``top_k // block_size`` key blocks of each query block
    (``block``).  ``deterministic_topk=False`` breaks the token
    selector's ties at random (the RL-determinism study,
    ``core.dsa.topk_noise``)."""
    index_heads: int = 32
    index_head_dim: int = 128
    top_k: int = 2048
    selector: str = "token"
    block_size: int = 128
    deterministic_topk: bool = True
    warmup_freeze_base: bool = True


@dataclass(frozen=True)
class MLAConfig:
    """Multi-latent attention dims (GLM-5 Table 10)."""
    q_lora_dim: int = 2048
    kv_lora_dim: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 256


@dataclass(frozen=True)
class MTPConfig:
    """Multi-token prediction with parameter sharing (GLM-5 §2.1)."""
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

    # MoE (routed top-k + shared experts)
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0         # leading dense-MLP layers
    router_aux_coef: float = 0.001
    capacity_factor: float = 1.25  # EP: an expert takes ceil(T k / E x this)

    # SSM (mamba1/mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1           # 1 = mamba1 (falcon-mamba), 2 = mamba2 (zamba2)
    ssm_head_dim: int = 64         # mamba2 only

    # hybrid (zamba2-style): one SHARED attention block applied every
    # ``hybrid_attn_every`` ssm layers.
    hybrid_attn_every: int = 0

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq_len: int = 0       # e.g. 1500 mel frames

    # modality frontend stub: 'none' | 'vision_stub' | 'audio_stub'
    frontend: str = "none"
    frontend_tokens: int = 0       # patches / frames the caller provides

    # implementation switches
    moe_impl: str = "auto"         # auto | dense | expert_parallel
    remat: str = "none"            # none | full
    remat_group: int = 1           # checkpoint every G layer-groups (tape/G)
    seq_parallel: bool = False     # residual stream sharded over 'model'

    # memory / compute layout of the training path
    q_chunk: int = 1024            # query rows a chunk (attention, DSA)
    loss_chunk: int = 512          # tokens a chunk of the CE backward

    def __post_init__(self):
        if self.moe_impl not in ("auto", "dense", "expert_parallel"):
            raise ValueError(f"moe_impl {self.moe_impl!r}: the reference "
                             f"has auto, dense and expert_parallel")
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat {self.remat!r}: the port checkpoints "
                             f"'full' layer groups or 'none'")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8
    seq_len: int = 512
    learning_rate: float = 2e-4
    warmup_steps: int = 20
    total_steps: int = 200
    muon_split: bool = True        # per-head orthogonalization (GLM-5 §2.1)
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    seed: int = 0


@dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workload shapes."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
