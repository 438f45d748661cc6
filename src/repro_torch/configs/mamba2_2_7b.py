"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space
duality), state=128, headdim=64, expand=2."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_ngroups=1, ssm_chunk=256,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4,
        ssm_ngroups=1, ssm_chunk=32, ce_chunk=32,
    )
