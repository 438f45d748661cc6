"""repro_torch.nn — model-block kernel zoo on the MVE frontend.

Real LM building blocks (KV-cache gather/scatter, online-softmax
attention, bit-plane int GEMM, SSM decode step, MoE expert gather)
written against :class:`repro_torch.frontend.KernelBuilder`, held
against the plain PyTorch oracles in :mod:`repro_torch.kernels.ref`, and
priced end-to-end on every registered target (docs/MODELS.md).

  ops      — composite numerics the base ISA lacks: exp polynomial,
             Newton reciprocal, cross-dimension tree reduction
  kernels  — the zoo: six block-kernel factories returning
             :class:`BlockRun` (kernel + memory + oracle check)
  blocks   — per-layer workload assembly from repro_torch.configs models
"""
from .kernels import (ATTN_ATOL, ATTN_RTOL, BLOCK_KERNELS,
                      MULTIDIM_BLOCKS, BlockRun, attn_tile, gemm_tile,
                      kv_gather, kv_scatter, moe_gather, ssm_scan)
from .blocks import BlockSpec, model_blocks
from . import ops

__all__ = [
    "ATTN_ATOL", "ATTN_RTOL", "BLOCK_KERNELS", "MULTIDIM_BLOCKS",
    "BlockRun", "BlockSpec", "attn_tile", "gemm_tile", "kv_gather",
    "kv_scatter", "model_blocks", "moe_gather", "ops", "ssm_scan",
]
