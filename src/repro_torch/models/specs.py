"""``input_specs()``: what every step function takes, for every
(architecture x shape cell), without allocating anything.

Each input is a :class:`~repro_torch.models.common.ShapeDtype` — the
port's ``jax.ShapeDtypeStruct``, a ``(shape, torch dtype)`` pair, the same
descriptor ``LM.abstract_params()`` gives — beside its logical axes, with
the reference's shapes, dtypes and axes.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ModelConfig, ShapeCell
from .common import ShapeDtype, abstract_tree, axes_tree
from .lm import LM


def _extra_inputs(cfg: ModelConfig, b: int, specs: Dict, axes: Dict) -> None:
    """A vlm's precomputed image embeddings, an encdec's frame embeddings
    (the two frontends are stubs in both packages)."""
    if cfg.family == "vlm":
        specs["image_embeds"] = ShapeDtype((b, cfg.num_image_tokens,
                                            cfg.d_model), torch.bfloat16)
        axes["image_embeds"] = ("batch", None, None)
    if cfg.family == "encdec":
        specs["frames"] = ShapeDtype((b, cfg.num_frames, cfg.d_model),
                                     torch.bfloat16)
        axes["frames"] = ("batch", None, None)


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell
                      ) -> Tuple[Dict, Dict]:
    """(descriptors, logical axes) for one training batch."""
    b, s = cell.global_batch, cell.seq_len
    specs = {
        "tokens": ShapeDtype((b, s), torch.int32),
        "targets": ShapeDtype((b, s), torch.int32),
        "loss_mask": ShapeDtype((b, s), torch.float32),
        "positions": ShapeDtype((b, s), torch.int32),
        "segment_ids": ShapeDtype((b, s), torch.int32),
    }
    axes = {k: ("batch", None) for k in specs}
    _extra_inputs(cfg, b, specs, axes)
    return specs, axes


def prefill_batch_specs(cfg: ModelConfig, cell: ShapeCell
                        ) -> Tuple[Dict, Dict]:
    b, s = cell.global_batch, cell.seq_len
    specs = {"tokens": ShapeDtype((b, s), torch.int32),
             "positions": ShapeDtype((b, s), torch.int32)}
    axes = {k: ("batch", None) for k in specs}
    _extra_inputs(cfg, b, specs, axes)
    return specs, axes


def decode_specs(cfg: ModelConfig, cell: ShapeCell
                 ) -> Tuple[Dict, Dict, Dict, Dict]:
    """Returns (cache descriptors, cache axes, token descriptors, token
    axes)."""
    cache_defs = LM(cfg).cache_defs(cell.global_batch, cell.seq_len)
    tok = {"tokens": ShapeDtype((cell.global_batch, 1), torch.int32)}
    return (abstract_tree(cache_defs), axes_tree(cache_defs), tok,
            {"tokens": ("batch", None)})


def input_specs(cfg: ModelConfig, cell: ShapeCell):
    """Unified entry: what the step function of ``cell.kind`` takes."""
    if cell.kind == "train":
        return train_batch_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_batch_specs(cfg, cell)
    if cell.kind == "decode":
        return decode_specs(cfg, cell)
    raise ValueError(cell.kind)

