"""Snowflake Arctic-480B [hf:Snowflake/snowflake-arctic-base] —
128-expert top-2 MoE with a parallel dense residual MLP."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    activation="silu",
    num_experts=128, experts_per_token=2, moe_dense_residual=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="arctic-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=512, head_dim=16,
        num_experts=8, experts_per_token=2, moe_dense_residual=True,
        moe_group_size=64, attn_chunk=32, ce_chunk=32,
    )
