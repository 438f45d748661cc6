"""The work the rooflines and ``mfu`` divide by, against hand counts at
tiny shapes."""
from __future__ import annotations

import types

import numpy as np
import pytest

from portbench import counts, harness, metrics_common
from portbench.tests.conftest import tiny_cell

TINY = dict(hidden_size=4, intermediate_size=8, num_attention_heads=2,
            num_key_value_heads=1, head_dim=2, num_hidden_layers=1,
            vocab_size=10)


def test_matmul_params_by_hand():
    # q 4x4, k and v 4x2 each, o 4x4, gated MLP 3 x 4x8, head 4x10
    assert counts.matmul_params(TINY) == 16 + 8 + 8 + 16 + 96 + 40


def test_pairs_by_hand():
    assert counts.causal_pairs(4) == 10
    seg = np.array([[1, 1, 1, 2, 2, 0], [1, 1, 1, 1, 1, 1]])
    assert counts.document_pairs(seg) == (6 + 3) + 21


def test_step_flops_and_flash_operations_by_hand():
    tokens, pairs = 12, 30
    assert counts.step_model_flops(TINY, tokens, pairs) == \
        6 * 184 * 12 + 12 * 1 * 2 * 2 * 30
    assert counts.flash_step_operations(TINY, pairs) == 14 * 2 * 2 * 1 * 30


def test_qwen2_matmul_params():
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "qwen2-7b.json")
    # q and o 3584 x 3584, k and v 3584 x (4 x 128), gated MLP 3 x 3584 x
    # 18944; the untied head once (the embedding is a lookup)
    layer = 3584 * 3584 * 2 + 3584 * 512 * 2 + 3 * 3584 * 18944
    assert counts.matmul_params(cfg) == 4 * layer + 3584 * 152064


def _prog(*ins):
    return [dict(i) for i in ins]


def test_mve_bytes_by_hand():
    lanes = 16
    prog = _prog({"op": "vsetdimc", "imm": 1},
                 {"op": "vsetdiml", "dim": 0, "length": 8},
                 {"op": "vsld", "base": 0, "modes": [1]},       # 8 distinct
                 {"op": "vsld", "base": 3, "modes": [0]},       # 1 distinct
                 {"op": "vsst", "base": 20, "modes": [1]},      # 8 land
                 {"op": "vsetdimc", "imm": 2},
                 {"op": "vsetdiml", "dim": 1, "length": 2},
                 {"op": "vsetdiml", "dim": 0, "length": 4},
                 {"op": "vunsetmask", "mask_index": 0},
                 # the top element 0 masked off: lanes of y = 1, at
                 # base + x + 4 y
                 {"op": "vsst", "base": 20, "modes": [1, 2]},   # 24..27
                 {"op": "vsst", "base": 26, "modes": [1, 2]})   # 30, 31 land
    got = counts.mve_access_bytes(prog, memory_elements=32, lanes=lanes)
    assert got["load"] == ((8 + 16) + (1 + 16)) * 4
    assert got["store"] == 2 * (8 + 4 + 2) * 4


def test_mve_bytes_of_the_frozen_transpose():
    cfg = harness.load_json(harness.BENCH_DIR / "configs" / "mve-table4.json")
    p = cfg["patterns"]["transpose"]
    got = counts.mve_access_bytes(p["program"], p["memory_elements"], 8192)
    # 512 x 49 read once, 4 loads filling 8192 lanes; the same written back
    assert got["load"] == (512 * 49 + 4 * 8192) * 4
    assert got["store"] == 2 * 512 * 49 * 4


@pytest.mark.parametrize("name, within_documents", [
    ("qwen2-7b.train-packed-4k", True),
    ("qwen2-7b.train-stream-4k", False)])
def test_mfu_pairs_follow_the_mix(name, within_documents):
    cell = tiny_cell(name)
    seed = 2**31 + 5
    from portbench import lm
    fed = lm.reference_batches(cell.config, cell.traffic, seed, 6)
    outcome = types.SimpleNamespace(cell=cell, window={
        "steps": 2, "first_step": 3, "traced_from": 5, "traced_steps": 1,
        "batches": fed})
    tokens, pairs = metrics_common.train_work(outcome, traced=False)
    rows = cell.traffic["rows"]
    assert tokens == 2 * rows * 64
    if within_documents:
        want = 0
        for b in fed[3:5]:
            for row in b["segment_ids"]:
                for s in set(row[row > 0].tolist()):
                    n = int((row == s).sum())
                    want += n * (n + 1) // 2
    else:
        want = 2 * rows * 64 * 65 // 2
    assert pairs == want
    traced = metrics_common.train_work(outcome, traced=True)
    assert traced[0] == rows * 64
