"""Step-function factories shared by the serving drivers.

PyTorch runs eagerly, so a step is the model's method itself; the
reference's ``jitted_cell``, shardings and ``make_train_step`` come with
the mesh and training slices of the port (ROADMAP.md, queue A).
"""
from __future__ import annotations

from ..models.lm import LM


def make_prefill_step(model: LM):
    """``batch`` goes through whole: a vlm's ``image_embeds`` and an
    encdec's ``frames`` beside the tokens (:mod:`..models.specs`)."""
    def prefill_step(params, batch):
        return model.prefill(params, batch)
    return prefill_step


def make_decode_step(model: LM):
    def decode_step(params, cache, tokens, cache_index):
        return model.decode_step(params, cache, tokens, cache_index)
    return decode_step
