"""MDV lane packing — the MVE abstraction applied to framework layers.

The paper's central insight is that mobile kernels expose *limited 1D
parallelism* (average 635 elements, Section I), so a very wide SIMD engine
must be fed by flattening several loop dimensions onto the lane axis, with
*dimension-level* (not per-element) masking for irregularity.

This module reuses that insight at two places of the LM framework:

  * **Continuous-batching decode** (`LaneGrid`): decode exposes only
    ``batch`` parallelism per step — the analogue of a short 1D loop.  The
    grid packs (requests x speculative-draft positions / beams) onto a fixed
    lane axis and keeps one mask *bit per request* (the highest dimension),
    exactly like the paper's mask CR, instead of per-token predicates.

  * **Sequence packing** in the data pipeline (`pack_documents`): documents
    are the highest dimension; masking whole documents out of the loss is a
    dimension-level mask, while attention segmentation uses segment ids.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class LaneGrid:
    """Fixed-geometry lane grid with dimension-level masking.

    ``dims`` is (inner, ..., top) like an MVE logical register; the top
    dimension carries the mask (one bit per top element, capped the same
    way as the paper's 256-entry mask CR).
    """

    dims: Tuple[int, ...]
    max_top_mask: int = 256

    def __post_init__(self):
        if self.dims[-1] > self.max_top_mask:
            raise ValueError(
                f"top dimension {self.dims[-1]} exceeds mask capacity "
                f"{self.max_top_mask}")
        self._mask = np.zeros(self.dims[-1], dtype=bool)
        self._payload: List[Optional[object]] = [None] * self.dims[-1]

    @property
    def lanes(self) -> int:
        return int(np.prod(self.dims))

    @property
    def top(self) -> int:
        return self.dims[-1]

    @property
    def mask(self) -> np.ndarray:
        return self._mask.copy()

    def lane_mask(self) -> np.ndarray:
        """Expand the top-dim mask to a per-lane boolean of shape dims."""
        inner = int(np.prod(self.dims[:-1]))
        return np.repeat(self._mask, inner).reshape(
            tuple(reversed(self.dims)))

    def occupancy(self) -> float:
        return float(self._mask.mean())

    def allocate(self, payload: object) -> Optional[int]:
        """Claim a top-dim slot; returns its index or None when full."""
        free = np.nonzero(~self._mask)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        self._mask[slot] = True
        self._payload[slot] = payload
        return slot

    def release(self, slot: int) -> object:
        if not self._mask[slot]:
            raise KeyError(f"slot {slot} is not allocated")
        self._mask[slot] = False
        payload, self._payload[slot] = self._payload[slot], None
        return payload

    def payload(self, slot: int):
        return self._payload[slot]

    def active_slots(self) -> np.ndarray:
        return np.nonzero(self._mask)[0]


def pack_documents(docs: Sequence[np.ndarray], seq_len: int,
                   pad_id: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Greedy first-fit packing of documents into rows of ``seq_len``.

    Returns (tokens, segment_ids, positions); ``segment_ids == 0`` marks
    padding (the dimension-level "masked off" documents).  Documents longer
    than ``seq_len`` are split.
    """
    rows: List[List[np.ndarray]] = []
    room: List[int] = []
    pieces: List[np.ndarray] = []
    for d in docs:
        d = np.asarray(d)
        for s in range(0, len(d), seq_len):
            pieces.append(d[s:s + seq_len])
    for piece in pieces:
        placed = False
        for i in range(len(rows)):
            if room[i] >= len(piece):
                rows[i].append(piece)
                room[i] -= len(piece)
                placed = True
                break
        if not placed:
            rows.append([piece])
            room.append(seq_len - len(piece))

    n = len(rows)
    tokens = np.full((n, seq_len), pad_id, dtype=np.int32)
    segment_ids = np.zeros((n, seq_len), dtype=np.int32)
    positions = np.zeros((n, seq_len), dtype=np.int32)
    for i, row in enumerate(rows):
        ofs = 0
        for j, piece in enumerate(row):
            k = len(piece)
            tokens[i, ofs:ofs + k] = piece
            segment_ids[i, ofs:ofs + k] = j + 1
            positions[i, ofs:ofs + k] = np.arange(k)
            ofs += k
    return tokens, segment_ids, positions
