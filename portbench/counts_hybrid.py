"""Model FLOPs of a Zamba2 training step (``configs/zamba2-7b.json``),
counted from the published sizes and the batch's documents, as
``counts.py`` counts the dense model's: nothing here asks the program what
it did."""
from __future__ import annotations

from portbench.lm_hybrid import sizes


def matmul_params(cfg: dict) -> int:
    """Parameters a token meets in a matrix product: each Mamba2 layer's
    in_proj (z, x, B, C, dt) and out_proj; each shared-block application's
    q, k, v over ``2 d``, o, gate_up and down (a block applied twice counts
    twice), its adapter's two matrices and its ``d x d`` linear; the output
    head once (the embedding's lookup is no product; tied, the head is the
    same matrix)."""
    s = sizes(cfg)
    d, ff, r = s["d"], s["ff"], s["r"]
    mamba = d * (2 * s["din"] + 2 * s["g"] * s["n"] + s["h"]) + s["din"] * d
    shared = 2 * d * (s["nq"] + 2 * s["nkv"]) + s["nq"] * d + 3 * d * ff
    application = shared + d * r + r * 2 * ff + d * d
    return s["L"] * mamba + s["apps"] * application + d * cfg["vocab_size"]


def ssd_flops_per_token(cfg: dict) -> int:
    """One Mamba2 layer's SSD products a token, forward, over whole chunks
    of ``chunk_size`` (L): C B^T (2 L N a group), the decayed scores times
    x (2 L P a head), a chunk's input state and its read-out (2 N P a head
    each)."""
    s = sizes(cfg)
    chunk, p = cfg["chunk_size"], cfg["mamba_headdim"]
    return (2 * chunk * s["n"] * s["g"] + 2 * chunk * p * s["h"]
            + 4 * s["n"] * p * s["h"])


def step_model_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """6 x matmul parameters x tokens; attention's two products forward
    and backward, 12 x applications x heads x head_dim x visible pairs;
    and the SSD's products forward and backward, 3 x
    :func:`ssd_flops_per_token` x tokens x layers."""
    s = sizes(cfg)
    attention = 12 * s["apps"] * s["nq"] * pairs
    ssd = 3 * ssd_flops_per_token(cfg) * tokens * s["L"]
    return 6.0 * matmul_params(cfg) * tokens + float(attention + ssd)
