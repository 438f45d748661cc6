"""Arithmetic that several per-layer readers share."""
from __future__ import annotations

from portbench import counts


def idle_share(outcome):
    """Per cent of the traced slice with no device operation running."""
    trace = outcome.trace
    if trace is None or trace.window_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def mve_roofline(outcome, kind: str, kernels):
    """Per cent of the bytes bound: the ``kind`` ("load" or "store") bytes
    of every traced batch, from the frozen programs, over the summed
    device time of the kernels whose names hold ``kernels``."""
    trace = outcome.trace
    if trace is None:
        return None
    seconds = trace.seconds_of(tuple(kernels))
    if seconds <= 0:
        return None
    config = outcome.cell.config
    lanes = config["machine"]["num_arrays"] * config["machine"]["bitlines"]
    per_image = {}
    total = 0
    for name in outcome.window["traced_patterns"]:
        if name not in per_image:
            pattern = config["patterns"][name]
            per_image[name] = counts.mve_access_bytes(
                pattern["program"], pattern["memory_elements"], lanes)[kind]
        total += per_image[name]
    total *= outcome.window["images_per_batch"]
    return 100.0 * total / counts.HBM_BYTES_PER_S / seconds


def train_work(outcome, traced: bool):
    """``(tokens, visible attention pairs)`` of the window's steps (or of
    the traced steps), from the batches the run fed, which the check has
    held equal to the reference's packing of the seed's documents: pairs
    within each document where the mix keeps segment ids, causal over each
    row where it does not."""
    w = outcome.window
    n = w["traced_steps"] if traced else w["steps"]
    if not n:
        return None
    start = w["traced_from"] if traced else w["first_step"]
    tokens = pairs = 0
    for b in w["batches"][start:start + n]:
        rows, seq = b["tokens"].shape
        tokens += rows * seq
        pairs += (counts.document_pairs(b["segment_ids"])
                  if "segment_ids" in b else rows * counts.causal_pairs(seq))
    return tokens, pairs
