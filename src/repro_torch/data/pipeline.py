"""Deterministic, shardable synthetic-text data pipeline — the reference's
(``repro/data/pipeline.py``), which imports no JAX, carried over as it is:
its batches are bit-equal to the reference's.  Host NumPy; the train loop
moves each batch to the device.

Design mirrors a production loader:

  * a *source* yields variable-length documents deterministically from
    (seed, document index) — any host can materialize any index, which is
    what makes elastic restarts and data-parallel sharding trivial;
  * documents are packed into fixed (batch, seq) rows with the MVE
    dimension-level-mask idiom
    (:func:`repro_torch.core.packing.pack_documents`):
    per-document segment ids give attention isolation and the loss mask is
    a *document-level* mask, not per-token predicates;
  * host sharding: host h of H reads documents h, h+H, h+2H, ... so the
    global batch order is independent of host count (elastic rescaling
    keeps determinism).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List

import numpy as np

from .. import obs
from ..core.packing import pack_documents


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    min_doc_len: int = 16


class SyntheticTextSource:
    """Deterministic documents: doc i is fully determined by (seed, i).

    Token stream is a stationary Markov-ish hash chain, so a model can
    actually learn structure from it (used by the training examples to
    show decreasing loss).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def doc_length(self, index: int) -> int:
        rng = np.random.default_rng((self.cfg.seed, index, 1))
        ln = int(rng.poisson(self.cfg.mean_doc_len))
        return max(self.cfg.min_doc_len, ln)

    def document(self, index: int) -> np.ndarray:
        cfg = self.cfg
        n = self.doc_length(index)
        rng = np.random.default_rng((cfg.seed, index, 2))
        # order-1 structure: next token = f(prev) with noise
        toks = np.empty(n, dtype=np.int32)
        toks[0] = rng.integers(2, cfg.vocab_size)
        noise = rng.random(n)
        jumps = rng.integers(2, cfg.vocab_size, size=n)
        for t in range(1, n):
            if noise[t] < 0.7:
                toks[t] = (toks[t - 1] * 31 + 17) % (cfg.vocab_size - 2) + 2
            else:
                toks[t] = jumps[t]
        return toks


def shard_for_host(indices: np.ndarray, host: int,
                   num_hosts: int) -> np.ndarray:
    return indices[indices % num_hosts == host]


def make_train_batches(cfg: DataConfig, host: int = 0, num_hosts: int = 1,
                       start_doc: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Yields packed batches {tokens, targets, loss_mask, positions,
    segment_ids} of shape (global_batch/num_hosts, seq_len)."""
    src = SyntheticTextSource(cfg)
    rows_needed = cfg.global_batch // num_hosts
    doc = start_doc + host
    stride = num_hosts
    buf: List[np.ndarray] = []
    while True:
        with obs.span("data.pack"):      # ended before the batch is yielded
            # over-fetch documents until packing yields enough rows
            while True:
                buf.append(src.document(doc))
                doc += stride
                tokens, segs, pos = pack_documents(buf, cfg.seq_len + 1)
                if len(tokens) > rows_needed:   # keep leftover docs
                    tokens, segs, pos = tokens[:rows_needed], \
                        segs[:rows_needed], pos[:rows_needed]
                    buf = []
                    break
            batch = {
                "tokens": tokens[:, :-1].astype(np.int32),
                "targets": tokens[:, 1:].astype(np.int32),
                "loss_mask": (segs[:, 1:] > 0).astype(np.float32),
                "positions": pos[:, :-1].astype(np.int32),
                "segment_ids": segs[:, :-1].astype(np.int32),
                "next_doc": np.asarray(doc, np.int64),
            }
        yield batch
