"""Qwen2-72B [arXiv:2407.10671; hf] — dense GQA with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=29568, vocab_size=152064, head_dim=128,
    activation="silu", qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-72b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        activation="silu", qkv_bias=True, attn_chunk=32, ce_chunk=32,
    )
