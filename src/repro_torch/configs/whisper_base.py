"""Whisper-base [arXiv:2212.04356] — encoder-decoder; conv audio frontend
is a STUB (input_specs provides precomputed frame embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    d_ff=2048, vocab_size=51865, head_dim=64,
    activation="gelu",
    encoder_layers=6, num_frames=1500,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        activation="gelu", encoder_layers=2, num_frames=32,
        attn_chunk=32, ce_chunk=32,
    )
