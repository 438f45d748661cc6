"""AdamW with decoupled weight decay, global-norm clipping and a
linear-warmup + cosine-decay schedule, as the reference's: plain functions
on nested dicts of tensors (not a ``torch.optim.Optimizer``), so a state
and a step are the reference's and cross between the packages
(:func:`repro_torch.convert.opt_state_from_reference`).

The state holds the moments in fp32 (``state_format="fp32"``) or
block-quantized to int8 with one fp32 absmax scale per row
(``"int8"``: ``{"q", "s"}`` per moment leaf), and the step as an int32
scalar tensor.  Every update runs in fp32 on the parameters' device and is
cast back to the parameter's type; nothing is read back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .. import obs
from ..trees import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    # "fp32" keeps m/v in float32 (8 bytes/param); "int8" stores both
    # moments block-quantized (per-row absmax scales, ~2 bytes/param)
    state_format: str = "fp32"


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor): a linear warmup
    over ``warmup_steps``, then a cosine decay to ``min_lr_ratio * lr`` at
    ``total_steps``; fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    progress = (step - cfg.warmup_steps) / max(
        cfg.total_steps - cfg.warmup_steps, 1)
    progress = torch.clamp(progress, 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * progress))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, decay)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32 (the leaves summed
    in the reference's order)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for _, x in tree_leaves(tree)))


def _scale_shape(shape) -> Tuple[int, ...]:
    shape = tuple(shape)
    return (shape[:-1] + (1,)) if shape else (1,)


def _quantize_moment(x: torch.Tensor, signed: bool,
                     row_max=None) -> Dict[str, torch.Tensor]:
    """Per-row absmax int8 quantization of one moment tensor; ``row_max``
    reduces the rows' absmax where a row is split over ranks.  The scale
    is ``amax * (1 / 127)``, 1/127 rounded to float32, as the reference's
    compiled step computes ``amax / 127`` (XLA divides by a constant as a
    product with its reciprocal); the same bits on the CPU and the card."""
    amax = (torch.amax(torch.abs(x), dim=-1, keepdim=True) if x.dim()
            else torch.abs(x)[None])
    if row_max is not None:
        amax = row_max(amax)
    scale = torch.clamp(amax, min=1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(x / scale), -127 if signed else 0, 127)
    return {"q": q.to(torch.int8),
            "s": scale.to(torch.float32).reshape(_scale_shape(x.shape))}


def _dequantize_moment(st: Dict[str, torch.Tensor], shape) -> torch.Tensor:
    s = st["s"] if len(shape) else st["s"].reshape(())
    return st["q"].to(torch.float32).reshape(shape) * s


def adamw_init(params, state_format: str = "fp32") -> Dict[str, Any]:
    """Zero moments in ``state_format`` beside ``params``, step 0."""
    if state_format not in ("fp32", "int8"):
        raise ValueError(f"unknown state_format {state_format!r}")
    device = tree_leaves(params)[0][1].device

    def zeros(p):
        if state_format == "int8":
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(_scale_shape(p.shape),
                                     dtype=torch.float32, device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state, grad_norm=None,
                 row_max=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: returns (new params, new state, ``{"lr",
    "grad_norm"}``).  New tensors; the arguments are not written.

    On a mesh each rank updates its own shard of every leaf: it passes the
    norm of the whole gradient as ``grad_norm``, and for int8 moments a
    tree like ``params`` whose leaves reduce a moment's row absmax over
    the ranks that split its rows (``None`` where a row is whole)."""
    with obs.span("optim.adamw", device=True):
        return _update(cfg, params, grads, state, grad_norm, row_max)


def _update(cfg: AdamWConfig, params, grads, state, grad_norm, row_max):
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    # ``number / tensor`` would be the tensor's reciprocal times the number
    scale = torch.clamp(torch.div(cfg.clip_norm,
                                  torch.clamp(gnorm, min=1e-9)), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    quant = cfg.state_format == "int8"

    def upd(p, g, m, v, reduce=None):
        v_floor = 0.0
        if quant:
            # entries of v below half a quantization step read back as 0;
            # floor the denominator by the step's sqrt so those rows take
            # a bounded (not eps-divided) update
            v_floor = torch.sqrt(v["s"] / bc2)
            v_floor = (v_floor.expand(p.shape) if p.dim()
                       else v_floor.reshape(()))
            m = _dequantize_moment(m, p.shape)
            v = _dequantize_moment(v, p.shape)
        g = g.to(torch.float32) * scale
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + v_floor + cfg.eps)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        if quant:
            m = _quantize_moment(m, signed=True, row_max=reduce)
            v = _quantize_moment(v, signed=True, row_max=reduce)
        return new_p.to(p.dtype), m, v

    # an int8 moment's node is its {"q", "s"} dict, passed to upd whole
    others = (state["m"], state["v"]) + (() if row_max is None
                                         else (row_max,))
    out = tree_map(upd, params, grads, *others)
    pick = (lambda i: tree_map(lambda o: o[i], out)
            if isinstance(out, dict) else out[i])
    new_state = {"m": pick(1), "v": pick(2), "step": step}
    return pick(0), new_state, {"lr": lr, "grad_norm": gnorm}
