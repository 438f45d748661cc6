"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone with two
alternating *shared* attention+MLP blocks applied every 6 layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    activation="gelu",
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_ngroups=1, ssm_chunk=256,
    attn_every=6, num_shared_blocks=2,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        activation="gelu",
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4,
        ssm_chunk=32, attn_every=2, num_shared_blocks=2,
        attn_chunk=32, ce_chunk=32,
    )
