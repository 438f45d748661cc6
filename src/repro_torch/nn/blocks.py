"""Per-layer model workloads assembled from the block kernel zoo.

:func:`model_blocks` maps a registered architecture config
(:mod:`repro_torch.configs`) onto the zoo: each :class:`BlockSpec` pairs one
built :class:`~repro_torch.nn.kernels.BlockRun` (a power-of-two *tile* of the
real layer shapes — the engine's lane grid and the frontend's
power-of-two tree reduction set the tiling) with the first-order
``tiles_per_layer`` multiplier that scales the tile's priced
cycles/energy back up to one full transformer layer.  The formulas are
deliberately first-order (perfect tiling, no edge tiles, no inter-tile
reuse) and documented in docs/MODELS.md — the bench reports per-tile
numbers alongside the multiplier rather than hiding the model.

The attention/KV blocks tile the default arch (qwen2-0.5b class); the
SSM step borrows its state dims from the mamba2-2.7b config and the MoE
gather its routing shape from llama4-scout — one zoo pricing all three
LM families on identical hardware.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

from ..configs import get_config
from .kernels import (BLOCK_KERNELS, MULTIDIM_BLOCKS, BlockRun, attn_tile,
                      gemm_tile, kv_gather, kv_scatter, moe_gather,
                      ssm_scan)


def _pow2_floor(x: int, cap: int) -> int:
    """Largest power of two <= min(x, cap) (tile sizes must be pow2)."""
    x = min(int(x), int(cap))
    p = 1
    while p * 2 <= x:
        p *= 2
    return p


@dataclasses.dataclass
class BlockSpec:
    """One priced workload row: a built tile + its per-layer multiplier."""

    name: str
    run: BlockRun
    tiles_per_layer: float
    arch: str
    note: str = ""

    @property
    def multidim(self) -> bool:
        return self.run.name in MULTIDIM_BLOCKS


def model_blocks(arch: str = "qwen2-0.5b", seq_len: int = 128,
                 quick: bool = False, seed: int = 0) -> List[BlockSpec]:
    """Build the per-layer block workloads for ``arch`` at decode step
    ``seq_len`` (the KV history length a decode token touches).

    Returns seven specs: the KV gather/scatter pair, the attention score
    tile, the QKV and MLP GEMM tiles, the SSM decode step (mamba2 dims)
    and the MoE expert gather (llama4-scout routing).  ``quick`` shrinks
    every tile for smoke runs; tile-count formulas are unchanged.
    ``seed`` is added to every block's data seed: 0 gives the reference's
    images, another value other images under the same programs.
    """
    cfg = get_config(arch, reduced=quick)
    ssm_cfg = get_config("mamba2-2.7b", reduced=quick)
    moe_cfg = get_config("llama4-scout-17b-a16e", reduced=quick)

    hd = _pow2_floor(cfg.resolved_head_dim, 16 if quick else 64)
    n_kv = _pow2_floor(max(cfg.num_kv_heads, 1), 2 if quick else 4)
    window = _pow2_floor(seq_len, 16 if quick else 64)
    max_seq = 2 * window
    # attention tile: tq query rows x tk cached keys per (head, tile)
    tq = 16 if quick else 64
    tk = 8 if quick else 32
    chunk = 4 if quick else 16
    d_attn = _pow2_floor(cfg.resolved_head_dim, 8 if quick else 16)
    # GEMM tiles: N tokens x K contraction x M output columns
    gn, gk, gm = (16, 4, 16) if quick else (64, 8, 64)
    # SSM: state width must be a power of two for the tree reduction
    ns = _pow2_floor(max(ssm_cfg.ssm_state, 4), 8 if quick else 64)
    di = _pow2_floor(ssm_cfg.d_inner, 32 if quick else 128)
    # MoE: llama4-scout routes each token to 1 expert + 1 shared
    topk = max(moe_cfg.experts_per_token, 1) + 1
    ne = _pow2_floor(max(moe_cfg.num_experts, 2), 4 if quick else 16)
    tokens = 16 if quick else 64
    de = 16 if quick else 32

    kv_elems = seq_len * cfg.num_kv_heads * cfg.resolved_head_dim
    tile_elems = window * n_kv * hd
    kv_tiles = max(1.0, kv_elems / tile_elems)

    attn_tiles = (cfg.num_heads *
                  max(1.0, seq_len / tk) * max(1.0, 1 / tq))

    hd_full = cfg.resolved_head_dim
    qkv_k = cfg.d_model
    qkv_m = (cfg.num_heads + 2 * cfg.num_kv_heads) * hd_full
    qkv_tiles = max(1.0, (1 * qkv_k * qkv_m) / (gn * gk * gm))
    mlp_macs = 3 * cfg.d_model * cfg.d_ff          # gated SwiGLU
    mlp_tiles = max(1.0, mlp_macs / (gn * gk * gm))

    ssm_tiles = max(1.0, (ssm_cfg.d_inner * ssm_cfg.ssm_state) / (di * ns))
    moe_tiles = max(1.0, moe_cfg.d_model / de)

    return [
        BlockSpec("kv_gather",
                  kv_gather(window=window, n_kv=n_kv, head_dim=hd,
                            max_seq=max_seq, pos0=window // 4,
                            seed=seed),
                  kv_tiles, arch,
                  note=f"decode step reads {seq_len}x{cfg.num_kv_heads}"
                       f"x{cfg.resolved_head_dim} KV history"),
        BlockSpec("kv_scatter",
                  kv_scatter(window=window, n_kv=n_kv, head_dim=hd,
                             max_seq=max_seq, pos0=window // 4,
                             seed=1 + seed),
                  kv_tiles, arch,
                  note="cache append / page compaction write side"),
        BlockSpec("attn_tile",
                  attn_tile(tq=tq, tk=tk, d=d_attn, chunk=chunk,
                            seed=2 + seed),
                  attn_tiles, arch,
                  note=f"{cfg.num_heads} heads x ceil({seq_len}/{tk}) "
                       "kv chunks"),
        BlockSpec("qkv_gemm", gemm_tile(n=gn, kdim=gk, m=gm, seed=30 + seed),
                  qkv_tiles, arch,
                  note=f"QKV projection {qkv_k}->{qkv_m} per token"),
        BlockSpec("mlp_gemm", gemm_tile(n=gn, kdim=gk, m=gm, seed=31 + seed),
                  mlp_tiles, arch,
                  note=f"gated MLP 3x{cfg.d_model}x{cfg.d_ff} MACs"),
        BlockSpec("ssm_scan", ssm_scan(n_state=ns, d_inner=di, seed=4 + seed),
                  ssm_tiles, ssm_cfg.name,
                  note=f"mamba2 decode step {ssm_cfg.d_inner}"
                       f"x{ssm_cfg.ssm_state} state"),
        BlockSpec("moe_gather",
                  moe_gather(tokens=tokens, d_expert=de, n_experts=ne,
                             topk=topk, seed=5 + seed),
                  moe_tiles, moe_cfg.name,
                  note=f"llama4-scout top-{topk} of "
                       f"{moe_cfg.num_experts} experts"),
    ]
