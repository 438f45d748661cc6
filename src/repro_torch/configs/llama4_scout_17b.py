"""Llama-4-Scout-17B-16E [hf:meta-llama] — MoE 16 experts top-1 with a
shared (early-fusion) expert."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    activation="silu", rope_theta=5e5,
    num_experts=16, experts_per_token=1, moe_shared_expert=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512, head_dim=16,
        num_experts=4, experts_per_token=1, moe_shared_expert=True,
        moe_group_size=64, attn_chunk=32, ce_chunk=32,
    )
