"""Shared fixtures of the benchmark's CPU tests: the checkout and the port
on the path, and the cells cut to a size the CPU holds (the loops take the
device they are given; only ``portbench.run`` insists on a CUDA device)."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from portbench import harness  # noqa: E402

TINY_LM = dict(hidden_size=128, num_attention_heads=2, num_key_value_heads=1,
               num_hidden_layers=2, intermediate_size=256, vocab_size=500)


def tiny_cell(name: str) -> harness.Cell:
    """The cell ``name`` at a size the CPU runs in seconds: 4 images a
    batch; a two-layer model of head dim 64 over 64-token rows."""
    cell = harness.find_cell(name)
    if cell.config["kind"] == "lm":
        cell.config = dict(cell.config, **TINY_LM,
                           run=dict(cell.config["run"], attn_chunk=32,
                                    ce_chunk=32))
        cell.traffic = dict(cell.traffic, seq_len=64, mean_doc_len=16,
                            min_doc_len=4)
    else:
        cell.traffic = dict(cell.traffic, images_per_batch=4, trace_rounds=2)
    return cell


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
