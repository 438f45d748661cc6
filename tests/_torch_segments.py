"""Segment ids for the tests of the flash route with ids: packed
documents, ids in no order, runs whose ids come back."""
import numpy as np


def packed_ids(b: int, s: int) -> np.ndarray:
    """Contiguous runs: a 30-token document, a one-token one, one across
    the 64- and 128-row tile edges, a pad tail of 0 (row 0); two documents
    on the tile edges and pads (row 1)."""
    rows = [[1] * 30 + [2] + [3] * 80 + [4] * 20,
            [5] * 64 + [6] * 64]
    out = np.zeros((b, s), np.int32)
    for i in range(b):
        run = rows[i % 2][:s]
        out[i, :len(run)] = run
    return out


def unordered_ids(b: int, s: int, seed: int = 0) -> np.ndarray:
    """Ids in no order: each position one of 0..4 (more than three
    distinct ids in a tile, each id scattered over the row)."""
    return np.random.default_rng(seed).integers(0, 5, (b, s)).astype(
        np.int32)


def repeated_ids(b: int, s: int) -> np.ndarray:
    """Runs whose ids come back: 1, 2, 1, 3, 2 over the row (a document
    split in two runs, pads of 0 between)."""
    pattern = [1] * 40 + [2] * 50 + [0] * 5 + [1] * 30 + [3] * 10 + [2] * 30
    row = np.resize(np.array(pattern, np.int32), s)
    return np.tile(row, (b, 1))


IDS = {"packed": packed_ids, "unordered": unordered_ids,
       "repeated": repeated_ids}
