"""Nemotron-4-15B [arXiv:2402.16819] — dense GQA with squared-ReLU MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    num_layers=32, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=24576, vocab_size=256000, head_dim=128,
    activation="squared_relu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        activation="squared_relu", attn_chunk=32, ce_chunk=32,
    )
