"""Qwen2-0.5B [arXiv:2407.10671; hf] — dense GQA (kv=2) with QKV bias."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-0.5b", family="dense",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151936, head_dim=64,
    activation="silu", qkv_bias=True, rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b-smoke", family="dense",
        num_layers=2, d_model=56, num_heads=7, num_kv_heads=1,
        d_ff=96, vocab_size=512, head_dim=8,
        activation="silu", qkv_bias=True, attn_chunk=32, ce_chunk=32,
    )
