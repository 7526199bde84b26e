"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local+global alternating attention (sliding window 4096) and logit
soft-capping (attn 50.0, final 30.0). [arXiv:2408.00118]

DSA applicability: retrofit applies to the *global* layers; local layers keep
their 4096 sliding window (already sub-quadratic).  ``long_500k`` is run with
the DSA-enabled variant (sparse decode) — see DESIGN.md.
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    citation="arXiv:2408.00118",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    max_seq_len=524288,
    attention_pattern=("local", "global"),
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu",
    tie_embeddings=True,
    dsa=DSAConfig(index_heads=8, index_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
