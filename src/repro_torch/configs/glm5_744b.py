"""GLM-5 744B-A40B — the paper's own architecture (GLM-5 Table 10).

80 layers (3 dense + 75 MoE + 1 MTP + output), d_model=6144, MLA with
Q-LoRA 2048 / KV-LoRA 512, qk head dim 192 (128 nope + 64 rope), v head dim
256 (the MLA-256 variant), 64 heads, 256 experts top-8 + 1 shared,
MoE d_ff 2048, dense d_ff 12288, vocab 154880, DSA indexer 32 heads x 128,
MTP with 3-step parameter sharing.

Its MLA layers write the DSA indexer keys into the cache and, as in the
reference, read none at serve time; the MTP head drafts speculative
tokens (``ContinuousEngine(spec_steps=3)``).
"""
from repro_torch.configs.base import DSAConfig, MLAConfig, MTPConfig, ModelConfig

CONFIG = ModelConfig(
    name="glm-5-744b",
    family="moe",
    citation="GLM-5 Table 10",
    num_layers=78,            # 3 dense + 75 MoE (MTP layer counted separately)
    d_model=6144,
    num_heads=64,
    num_kv_heads=64,          # MLA is MHA-style in train/prefill
    head_dim=192,             # qk head dim (nope+rope); v head dim in MLAConfig
    d_ff=12288,
    moe_d_ff=2048,
    vocab_size=154880,
    max_seq_len=524288,
    attention_type="mla",
    mla=MLAConfig(q_lora_dim=2048, kv_lora_dim=512, qk_rope_dim=64,
                  qk_nope_dim=128, v_head_dim=256),
    num_experts=256,
    experts_per_token=8,
    num_shared_experts=1,
    first_k_dense=3,
    mlp_activation="swiglu",
    dsa=DSAConfig(index_heads=32, index_head_dim=128, top_k=2048),
    mtp=MTPConfig(num_predict=3, share_params=True),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=48,
        d_ff=512, moe_d_ff=128, vocab_size=512, max_seq_len=1024,
        mla=MLAConfig(q_lora_dim=64, kv_lora_dim=32, qk_rope_dim=16,
                      qk_nope_dim=32, v_head_dim=64),
        num_experts=4, experts_per_token=2, first_k_dense=1,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
        mtp=MTPConfig(num_predict=3, share_params=True),
    )


def smoke_config_mla_baseline() -> ModelConfig:
    """Same geometry without DSA/MTP — the dense-MLA baseline of Table 3."""
    return smoke_config().replace(dsa=None, mtp=None)
