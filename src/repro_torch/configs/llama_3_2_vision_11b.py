"""Llama-3.2-11B-Vision [hf:meta-llama] — dense GQA decoder with
cross-attention image layers every 5th layer; vision frontend is a STUB
(input_specs provides precomputed patch embeddings)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    activation="silu", rope_theta=5e5,
    cross_attn_every=5, num_image_tokens=1024,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-smoke", family="vlm",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        cross_attn_every=2, num_image_tokens=16,
        attn_chunk=32, ce_chunk=32,
    )
