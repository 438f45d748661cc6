"""Zamba2-7B [arXiv:2411.15242; huggingface.co/Zyphra/Zamba2-7B-Instruct
``config.json``] as published: 81 Mamba2 layers (ngroups 2), two shared
attention + MLP blocks over the concatenation of the hidden state and the
embedding, applied before the 13 hybrid layers with a rank-128 MLP adapter
and a linear of each application's own, head dim 224, and the output head
tied to the embedding.  Not one of the reference's ten architectures
(``ARCH_IDS``): the ``zamba2`` family is the port's own."""
from .base import PublishedConfig

HYBRID_LAYER_IDS = (6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77)

CONFIG = PublishedConfig(
    name="zamba2-7b", family="zamba2",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000, head_dim=224,
    activation="gelu", rope_theta=10_000.0, norm_eps=1e-5,
    ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    ssm_ngroups=2, ssm_chunk=256, num_shared_blocks=2,
    hybrid_layer_ids=HYBRID_LAYER_IDS, adapter_rank=128,
    tie_embeddings=True,
)


def reduced() -> PublishedConfig:
    """Six layers, two of them hybrid (one application of each shared
    block), ngroups 2, head dim 2 d / heads as published."""
    return PublishedConfig(
        name="zamba2-7b-smoke", family="zamba2",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=96, vocab_size=512, head_dim=32,
        activation="gelu", rope_theta=10_000.0, norm_eps=1e-5,
        ssm_state=16, ssm_headdim=16, ssm_expand=2, ssm_conv=4,
        ssm_ngroups=2, ssm_chunk=16, num_shared_blocks=2,
        hybrid_layer_ids=(1, 4), adapter_rank=8, tie_embeddings=True,
        attn_chunk=16, ce_chunk=32,
    )
