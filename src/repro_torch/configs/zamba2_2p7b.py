"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000.

Mamba-2 backbone + a SHARED full-attention block applied every 6 mamba layers
(zamba2-style parameter reuse), ssm_state=64. [arXiv:2411.15242]

DSA applicability: the shared attention block only; the mamba2 layers are
already linear-time.  Served by the ``ContinuousEngine`` (paged shared-block
KV, per-slot Mamba-2 state) and the static ``ServingEngine``.
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    citation="arXiv:2411.15242",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    max_seq_len=524288,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_version=2,
    ssm_head_dim=64,
    hybrid_attn_every=6,
    mlp_activation="gelu",
    dsa=DSAConfig(index_heads=8, index_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        ssm_state=16, hybrid_attn_every=2,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
