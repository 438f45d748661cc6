"""Granite-34B-Code [arXiv:2405.04324; hf] — llama-arch, MQA (kv=1)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    num_layers=88, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152, head_dim=128,
    activation="silu",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-34b-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=16,
        activation="silu", attn_chunk=32, ce_chunk=32,
    )
