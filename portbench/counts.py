"""The work that the rooflines and ``mfu`` divide by, counted from shapes.

Nothing here asks the program what it did: the MVE byte counts walk the
frozen programs' loads and stores as the ISA defines them (Algorithm 1,
stride modes, the highest dimension's mask), and the language model's
operations come from the configuration's published sizes and the batch's
documents.  So they read the same work whatever implements it.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

# NVIDIA H100 SXM, data sheet, dense: HBM3 bandwidth and bf16 tensor rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
IMAGE_ELEMENT_BYTES = 4        # a memory image holds float32 elements
MAX_DIMS = 4
MAX_TOP_DIM = 256


# ---------------------------------------------------------------------------
# MVE: bytes each vsld / vsst must move
# ---------------------------------------------------------------------------

def _strides(modes: Sequence[int], dims: Sequence[int],
             crs: Sequence[int]) -> List[int]:
    """Stride modes to strides: 0 replicates, 1 is sequential, 2 is
    derived (S_i = S_{i-1} * L_{i-1}, S_{-1} = 1), 3 reads the stride
    register; a dimension without a mode is sequential."""
    out: List[int] = []
    for d in range(len(dims)):
        mode = modes[d] if d < len(modes) else 1
        if mode == 0:
            out.append(0)
        elif mode == 1:
            out.append(1)
        elif mode == 2:
            out.append(out[d - 1] * dims[d - 1] if d else 1)
        else:
            out.append(crs[d])
    return out


def _lane_addresses(dims: Sequence[int], strides: Sequence[int], base: int,
                    lanes: int, top_mask: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Each active lane's address (dimension 0 fastest) and whether its
    highest-dimension element is masked in."""
    total = int(np.prod(dims))
    lane = np.arange(min(total, lanes), dtype=np.int64)
    addr = np.full(lane.shape, base, dtype=np.int64)
    rem = lane.copy()
    top = None
    for d, length in enumerate(dims):
        coord = rem % length
        rem //= length
        addr += coord * strides[d]
        top = coord
    return addr, top_mask[np.minimum(top, MAX_TOP_DIM - 1)]


def mve_access_bytes(program: Iterable[dict], memory_elements: int,
                     lanes: int) -> Dict[str, int]:
    """Bytes one image's strided loads and stores must move.

    ``vsld``: each distinct in-image address its lanes read, read once,
    and the whole register it fills (every lane: those past ``prod(dims)``
    are zero-filled), written once.  ``vsst``: each lane that stores (in
    the image, masked in), read once from the register and written once
    into the image.  Random-base accesses (``vrld``/``vrst``) are not
    strided walks and are not counted."""
    dim_count, dims = 1, [1] * MAX_DIMS
    ld_cr, st_cr = [0] * MAX_DIMS, [0] * MAX_DIMS
    top_mask = np.ones(MAX_TOP_DIM, dtype=bool)
    load = store = 0
    for ins in program:
        op = ins["op"]
        if op == "vsetdimc":
            dim_count = ins["imm"]
        elif op == "vsetdiml":
            dims[ins["dim"]] = ins["length"]
        elif op == "vsetldstr":
            ld_cr[ins["dim"]] = ins["stride"]
        elif op == "vsetststr":
            st_cr[ins["dim"]] = ins["stride"]
        elif op == "vsetmask":
            top_mask[ins["mask_index"]] = True
        elif op == "vunsetmask":
            top_mask[ins["mask_index"]] = False
        elif op in ("vsld", "vsst"):
            active = dims[:dim_count]
            crs = ld_cr if op == "vsld" else st_cr
            addr, masked_in = _lane_addresses(
                active, _strides(ins.get("modes", ()), active, crs),
                ins["base"], lanes, top_mask)
            if op == "vsld":
                inside = np.clip(addr, 0, memory_elements - 1)
                load += (np.unique(inside).size + lanes) * IMAGE_ELEMENT_BYTES
            else:
                wrapped = np.where(addr < 0, addr + memory_elements, addr)
                lands = masked_in & (wrapped >= 0) & (wrapped < memory_elements)
                store += 2 * int(lands.sum()) * IMAGE_ELEMENT_BYTES
    return {"load": load, "store": store}


# ---------------------------------------------------------------------------
# Language model: model FLOPs of a training step
# ---------------------------------------------------------------------------

def matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product, from the published sizes:
    per layer q, k, v, o and the gated MLP's three matrices, and the
    output head once (tied or not, it is one product over the vocab)."""
    d, ff = cfg["hidden_size"], cfg["intermediate_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    nq = cfg["num_attention_heads"] * hd
    nkv = cfg["num_key_value_heads"] * hd
    per_layer = d * nq + 2 * d * nkv + nq * d + 3 * d * ff
    return cfg["num_hidden_layers"] * per_layer + d * cfg["vocab_size"]


def causal_pairs(length: int) -> int:
    """Visible (query, key) pairs of causal attention over ``length``."""
    return length * (length + 1) // 2


def document_pairs(segment_ids: np.ndarray) -> int:
    """Visible pairs when each query sees the keys of its own document up
    to itself: a document of n tokens has n (n + 1) / 2; padding (segment
    0) is no document."""
    total = 0
    for row in np.asarray(segment_ids):
        ids, counts = np.unique(row[row > 0], return_counts=True)
        total += int(sum(causal_pairs(int(n)) for n in counts))
    return total


def step_model_flops(cfg: dict, tokens: int, pairs: int) -> float:
    """6 x matmul parameters x tokens, plus attention's two products
    (QK^T and PV, 2 operations a multiply-add) forward and backward
    (x 3): 12 x layers x heads x head_dim x visible pairs."""
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    attention = (12 * cfg["num_hidden_layers"] * cfg["num_attention_heads"]
                 * hd * pairs)
    return 6.0 * matmul_params(cfg) * tokens + float(attention)


def flash_step_operations(cfg: dict, pairs: int) -> float:
    """Operations the flash forward and backward need in one step: 4 D a
    visible pair a head forward, 10 D backward (a recomputed forward is
    not work the inputs need)."""
    hd = cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]
    return float((4 + 10) * hd * cfg["num_attention_heads"]
                 * cfg["num_hidden_layers"] * pairs)
