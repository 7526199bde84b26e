"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free) vocab=65024, state=16.

Mamba-1 architecture (selective scan, conv4, expand 2). [arXiv:2410.05355]
No attention, so no DSA; decode state is O(1) per layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    citation="arXiv:2410.05355",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=65024,
    max_seq_len=524288,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_version=1,
    dsa=None,
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, vocab_size=512, max_seq_len=1024,
        ssm_state=8, loss_chunk=128,
    )
