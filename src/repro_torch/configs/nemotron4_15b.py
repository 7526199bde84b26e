"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.

GQA with squared-ReLU MLP (no gating). [arXiv:2402.16819]
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    citation="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256000,
    max_seq_len=524288,
    mlp_activation="relu2",
    dsa=DSAConfig(index_heads=16, index_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=1024, vocab_size=512, max_seq_len=1024,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
