"""kimi-k2-1t-a32b [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840.

MoE: 384 experts, top-8 routed + 1 shared; first layer dense.  Trillion-param
MoE (paper-table entry). [arXiv:2501.kimi2]

The reference shards the experts over a mesh; the port runs the MoE layer
on one device (``layers.moe``), so on one card it serves at cut depth.
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    citation="arXiv:2501.kimi2",
    num_layers=61,
    d_model=7168,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=18432,              # dense-layer FFN width (first_k_dense layer)
    moe_d_ff=2048,
    vocab_size=163840,
    max_seq_len=524288,
    num_experts=384,
    experts_per_token=8,
    num_shared_experts=1,
    first_k_dense=1,
    mlp_activation="swiglu",
    dsa=DSAConfig(index_heads=32, index_head_dim=128),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, moe_d_ff=128, vocab_size=512, max_seq_len=1024,
        num_experts=4, experts_per_token=2, first_k_dense=1,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
