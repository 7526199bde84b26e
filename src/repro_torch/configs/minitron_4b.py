"""minitron-4b [dense] — 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.

Pruned Nemotron (width-pruned, distilled). [arXiv:2407.14679]
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    citation="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    max_seq_len=524288,
    mlp_activation="relu2",   # nemotron family uses squared-ReLU
    dsa=DSAConfig(index_heads=12, index_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
