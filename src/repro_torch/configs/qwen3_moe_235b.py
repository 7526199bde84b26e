"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536 vocab=151936.

MoE: 128 experts top-8, no shared expert; qk-norm. [hf:Qwen/Qwen3-30B-A3B]
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    citation="hf:Qwen/Qwen3-30B-A3B",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=12288,               # unused (first_k_dense=0); kept for completeness
    moe_d_ff=1536,
    vocab_size=151936,
    max_seq_len=524288,
    num_experts=128,
    experts_per_token=8,
    num_shared_experts=0,
    first_k_dense=0,
    mlp_activation="swiglu",
    qk_norm=True,
    dsa=DSAConfig(index_heads=32, index_head_dim=128),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, moe_d_ff=128, vocab_size=512, max_seq_len=1024,
        num_experts=4, experts_per_token=2,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
