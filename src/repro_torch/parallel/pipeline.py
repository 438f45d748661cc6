"""Pipeline parallelism: a GPipe schedule run by every rank of a stage axis.

Each rank along the ``stage`` mesh axis holds one stage's parameters;
microbatches stream to the next stage through point-to-point sends in a
loop over M + S - 1 schedule slots (the classic GPipe bubble).  The send is
an autograd function whose backward sends the gradient to the previous
stage (the reference's ``ppermute``, whose transpose is the reverse
permutation), so ``torch.autograd`` through :func:`pipeline_apply` yields
each stage's parameter gradients — no hand-written backward schedule is
needed for this forward-checkpointed formulation.

This complements the DP/FSDP shardings in ``parallel/axes.py``: on pods
larger than the 16-way TP sweet spot, stages replace depth-wise FSDP
regathering with point-to-point activation transfers (bubble fraction
(S-1)/(M+S-1), amortized by microbatch count).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .axes import sum_over_ranks


def _shift(x: torch.Tensor, group, stage: int, stages: int,
           step: int) -> torch.Tensor:
    """Send ``x`` to stage ``stage + step``; returns what stage
    ``stage - step`` sent (zeros where there is no such stage)."""
    x = x.contiguous()
    out = torch.zeros_like(x)
    ranks = dist.get_process_group_ranks(group)
    ops = []
    if 0 <= stage + step < stages:
        ops.append(dist.P2POp(dist.isend, x, ranks[stage + step], group))
    if 0 <= stage - step < stages:
        ops.append(dist.P2POp(dist.irecv, out, ranks[stage - step], group))
    for work in dist.batch_isend_irecv(ops) if ops else ():
        work.wait()
    return out


class _SendToNext(torch.autograd.Function):
    """Forward: ``y`` to stage s+1, the result from stage s-1 (zeros on
    stage 0).  Backward: the gradient to stage s-1, from stage s+1."""

    @staticmethod
    def forward(ctx, y, group, stage, stages):
        ctx.args = (group, stage, stages)
        return _shift(y, group, stage, stages, 1)

    @staticmethod
    def backward(ctx, grad):
        return (_shift(grad, *ctx.args, -1),) + (None,) * 3


def pipeline_apply(stage_fn: Callable, mesh, num_stages: int,
                   axis: str = "stage"):
    """Returns ``apply(stage_params, micro_x) -> (M, mb, ...)``, which every
    rank of ``mesh`` calls with its own stage's parameters and the same
    (M, mb, ...) microbatches; every rank gets the last stage's outputs.

    ``stage_fn(params, x) -> y`` must keep the activation shape (a
    residual-block stack), so it can flow through every stage."""
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)
    if dist.get_world_size(group) != num_stages:
        raise ValueError(f"the {axis!r} axis has "
                         f"{dist.get_world_size(group)} ranks, not "
                         f"{num_stages} stages")

    def apply(params, micro_x):
        m = micro_x.shape[0]
        dev = micro_x.device
        first = torch.tensor(stage == 0, device=dev)
        buf = torch.zeros_like(micro_x[0])
        outs = []
        for t in range(m + num_stages - 1):
            i = t - stage                       # microbatch index here
            active = torch.tensor(0 <= i < m, device=dev)
            x_in = torch.where(first, micro_x[min(max(i, 0), m - 1)], buf)
            y = stage_fn(params, x_in)
            y = torch.where(active, y, torch.zeros_like(y))
            outs.append(torch.where(active & (stage == num_stages - 1), y,
                                    torch.zeros_like(y)))
            buf = _SendToNext.apply(y, group, stage, num_stages)
        # only the last stage produced outputs; every rank gets them, and
        # the gradient goes to each rank's own term once
        outs = sum_over_ranks(torch.stack(outs), (group,))
        # slot t on the last stage carried microbatch t - (S-1)
        return outs[num_stages - 1:]

    return apply


def bubble_fraction(num_stages: int, num_micro: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_micro + num_stages - 1)
