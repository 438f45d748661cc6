"""Step-function factories shared by the training loop and the serving
drivers.

PyTorch runs eagerly, so a step is a plain function: the training step
differentiates ``LM.loss`` with ``torch.autograd`` and applies
:func:`~repro_torch.optim.adamw_update`; the prefill and decode steps are
the model's methods.  The reference's ``jitted_cell`` and its shardings
come with the mesh slice of the port (ROADMAP.md, queue A).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.common import (DTYPES, tree_leaves, tree_map,
                             tree_unflatten)
from ..models.lm import LM
from ..optim import AdamWConfig, adamw_update


def _value_and_grad(model: LM, params, batch):
    """``(loss, metrics), grads`` of ``model.loss`` at ``params`` (each leaf
    taken as a fresh autograd leaf); grads in the parameters' types (zero
    for a leaf the loss does not reach, as ``jax.grad`` gives),
    everything detached."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, flat = zip(*tree_leaves(leaves))
    loss, metrics = model.loss(leaves, batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    return ((loss.detach(), {k: m.detach() for k, m in metrics.items()}),
            tree_unflatten(leaves, dict(zip(paths, grads))))


def make_train_step(model: LM, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient by ``torch.autograd`` (with
    ``cfg.grad_accum > 1``, over that many microbatches of the batch's rows,
    summed in ``cfg.grad_accum_dtype`` accumulators and averaged, the loss
    and metrics averaged too), then one AdamW update.  ``batch``: tensors on
    the parameters' device
    (:func:`~repro_torch.models.specs.train_batch_specs`).  Metrics: ``ce``, ``aux``, ``tokens``, ``lr``, ``grad_norm``, ``loss``,
    as 0-dim tensors (reading one waits for the device)."""
    ga = model.cfg.grad_accum
    acc_dt = DTYPES[model.cfg.grad_accum_dtype]

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict, Dict[str, torch.Tensor]]:
        if ga <= 1:
            (loss, metrics), grads = _value_and_grad(model, params, batch)
        else:
            micro = {k: x.reshape(ga, x.shape[0] // ga, *x.shape[1:])
                     for k, x in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(p.shape, dtype=acc_dt,
                                                   device=p.device), params)
            dev = tree_leaves(params)[0][1].device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
                       for k in ("ce", "aux", "tokens")}
            for i in range(ga):
                (mb_loss, m), g = _value_and_grad(
                    model, params, {k: x[i] for k, x in micro.items()})
                gsum = tree_map(lambda a, b: a + b.to(acc_dt), gsum, g)
                loss = loss + mb_loss
                metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda g: g / ga, gsum)
            loss = loss / ga
            metrics = {k: x / ga for k, x in metrics.items()}
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {**metrics, **om, "loss": loss}
    return train_step


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
