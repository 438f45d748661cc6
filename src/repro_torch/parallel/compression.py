"""Gradient compression: int8 all-gather all-reduce with error feedback.

Distributed-optimization trick for the cross-pod gradient sync: the pod
axis has far less bandwidth than the links inside a pod, so gradients
crossing it are quantized to int8 with a max-shared scale.  An all-gather
of int8 shards moves half the bytes of a bf16 ring all-reduce at pod count
2 (and the error-feedback residual keeps SGD unbiased in expectation).

Two entry points, as the reference's:

  * :func:`compressed_allreduce_mean` — the collective, called by every
    rank of a process group;
  * :func:`make_dp_train_step` — a data-parallel trainer for
    replicated-parameter models (end-to-end compressed sync + error
    feedback), run by every rank of the mesh.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..trees import tree_map, value_and_grad
from .axes import all_reduce


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``round(x / scale)`` (half to even, as ``jnp.round``) clipped to
    [-127, 127], as int8."""
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax, 1e-8) / 127`` as the reference's compiled step computes
    it: XLA divides by a constant as a product with the constant's
    reciprocal rounded to float32, and so does this, on any device (a
    division rounded once differs from it in about one scale in 25).
    ``/ n`` below is the same: the reference's ``n`` is ``psum(1)``, a
    constant once compiled."""
    return torch.clamp(amax, min=1e-8) * (1.0 / 127.0)


def int8_payload(x: torch.Tensor, group=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What a rank sends: ``x`` quantized to int8 with the scale every rank
    of ``group`` shares (``all_reduce(MAX)`` of ``|x|``'s maximum), and the
    scale."""
    amax = torch.abs(x).max()
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = _scale(amax)
    return quantize_int8(x.to(torch.float32), scale), scale


def compressed_allreduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the ranks of ``group`` with int8 on the wire: each
    rank's :func:`int8_payload` is all-gathered, and the images are summed
    in float32 in rank order, then ``* scale * (1 / n)``."""
    n = dist.get_world_size(group)
    q, scale = int8_payload(x, group)
    gathered = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(gathered, q.reshape(-1),   # int8 on the wire
                                group=group)
    gathered = gathered.view((n,) + tuple(q.shape))
    return gathered.to(torch.float32).sum(dim=0) * scale * (1.0 / n)


def compress_with_feedback(grads, residual):
    """Apply error feedback: g' = g + residual; the caller transmits
    quantize(g') and keeps the new residual g' - dequant(quant(g')).
    Returns (the dequantized gradients in their own types, the new
    residual)."""
    def one(g, r):
        gf = g.to(torch.float32) + r
        scale = _scale(torch.abs(gf).max())
        deq = quantize_int8(gf, scale).to(torch.float32) * scale
        return deq.to(g.dtype), gf - deq
    out = tree_map(one, grads, residual)
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)


def make_dp_train_step(loss_fn: Callable, optimizer_update: Callable,
                       mesh, axis: str = "data", compress: bool = True):
    """Pure-DP trainer: params replicated, batch sharded over ``axis``,
    gradient mean over ``axis`` int8-compressed with error feedback (or
    a plain sum / n with ``compress=False``).

    ``loss_fn(params, batch) -> scalar``; ``optimizer_update(params,
    grads, opt_state) -> (params, opt_state)``.  Returns ``step(params,
    opt_state, residual, batch) -> (params, opt_state, residual, loss)``,
    which every rank of ``mesh`` calls with the whole batch: it takes its
    own block of the leading dim, as the reference's ``shard_map`` body
    sees it."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    index = mesh.get_local_rank(axis)

    def rows(x):
        if x.shape[0] % n:
            raise ValueError(f"batch of {x.shape[0]} rows does not split "
                             f"{n} ways over {axis!r}")
        block = x.shape[0] // n
        return x[index * block:(index + 1) * block]

    def step(params, opt_state, residual, batch):
        loss, grads = value_and_grad(loss_fn, params,
                                     tree_map(rows, batch))
        if compress:
            grads = tree_map(lambda g: compressed_allreduce_mean(
                g.to(torch.float32), group), grads)
            grads, residual = compress_with_feedback(grads, residual)
        else:
            grads = tree_map(lambda g: all_reduce(g, (group,)) * (1.0 / n),
                             grads)
        params, opt_state = optimizer_update(params, grads, opt_state)
        return (params, opt_state, residual,
                all_reduce(loss, (group,)) * (1.0 / n))

    return step


def zeros_like_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
