"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.

Encoder-decoder; conv + mel frontend is a STUB (``input_specs`` provides 1500
precomputed frame embeddings). [arXiv:2212.04356]

Shape coverage: ``train_4k``/``prefill_32k``/``decode_32k`` run with the text
decoder consuming the (stubbed) encoder output via cross-attention; the
decoder is a normal causal LM so long text sequences are well-defined.
``long_500k`` is SKIPPED (enc-dec transcript positions are bounded by design;
see DESIGN.md skip note).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    citation="arXiv:2212.04356",
    num_layers=6,             # decoder layers
    encoder_layers=6,
    encoder_seq_len=1500,     # mel frames after conv frontend (stubbed)
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    max_seq_len=32768,
    mlp_activation="gelu",
    frontend="audio_stub",
    frontend_tokens=1500,
    dsa=None,                 # 6-layer 512-dim decoder: sparsity not worthwhile
)


def smoke_config() -> ModelConfig:
    return CONFIG.replace(
        num_layers=2, encoder_layers=2, encoder_seq_len=64, frontend_tokens=64,
        d_model=128, num_heads=4, num_kv_heads=4, head_dim=32,
        d_ff=256, vocab_size=512, max_seq_len=1024,
        q_chunk=128, loss_chunk=128,
    )
