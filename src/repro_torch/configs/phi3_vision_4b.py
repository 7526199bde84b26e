"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

phi3-mini language backbone + CLIP vision encoder.
[hf:microsoft/Phi-3-vision-128k-instruct]

Per the brief, the vision frontend (ViT + projector) is a STUB: ``input_specs``
provides precomputed patch embeddings of shape (batch, frontend_tokens, d_model)
which are prepended to the text token embeddings.  We implement the language
decoder that consumes them.  kv=32 == MHA (no GQA grouping).
"""
from repro_torch.configs.base import DSAConfig, ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    citation="hf:microsoft/Phi-3-vision-128k-instruct",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    max_seq_len=524288,
    mlp_activation="swiglu",
    frontend="vision_stub",
    frontend_tokens=576,   # 24x24 CLIP patch grid
    dsa=DSAConfig(index_heads=16, index_head_dim=64),
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, max_seq_len=1024, frontend_tokens=16,
        dsa=DSAConfig(index_heads=2, index_head_dim=16, top_k=64, block_size=16),
        q_chunk=128, loss_chunk=128,
    )
