"""Step-function factories and the sharding trees shared by the training
loop and the serving drivers.

PyTorch runs eagerly, so a step is a plain function: the training step
differentiates ``LM.loss`` with ``torch.autograd`` and applies
:func:`~repro_torch.optim.adamw_update`; the prefill and decode steps are
the model's methods.  :func:`jitted_cell` builds the same steps over a
mesh, for every rank of it to call: parameters and optimizer moments are
``DTensor``s placed by :func:`~repro_torch.parallel.axes.spec_for` (FSDP
over ``data``, tensor, sequence and expert parallelism over ``model``),
the batch is split over the batch axes, and the loss and the gradient are
the whole batch's.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import obs
from ..configs.base import ModelConfig, ShapeCell
from ..models.common import DTYPES, ShapeDtype, abstract_tree, axes_tree
from ..models.lm import LM
from ..models.specs import (decode_specs, prefill_batch_specs,
                            train_batch_specs)
from ..optim import AdamWConfig, adamw_update
from ..optim.adamw import _scale_shape
from ..parallel.axes import (NamedPlacement, ShardingCtx, all_reduce,
                             batch_reduction, batch_split, local_shard,
                             mesh_shape, model_mesh, named_sharding,
                             on_model_mesh, shard_groups, step_context)
from ..trees import tree_leaves, tree_map, value_and_grad


def shardings_for(axes, shapes, ctx: ShardingCtx):
    """Tree of :class:`~repro_torch.parallel.axes.NamedPlacement` from
    parallel (axes, ``ShapeDtype``) trees."""
    return tree_map(lambda a, s: named_sharding(a, s.shape, ctx), axes,
                    shapes)


def replicated(ctx: ShardingCtx) -> NamedPlacement:
    return NamedPlacement(ctx.mesh,
                          (Replicate(),) * len(mesh_shape(ctx.mesh)))


def opt_state_axes(param_axes):
    return {"m": param_axes, "v": param_axes, "step": ()}


def state_shardings(model: LM, opt_cfg: AdamWConfig, ctx: ShardingCtx):
    """``{"params", "opt"}`` placements of a training state.  int8 moments:
    ``q`` placed like the parameter, the per-row scale like the
    parameter's leading dims (its last dim, of size 1, whole)."""
    p_abs, p_axes = model.abstract_params(), model.param_axes()
    p_shard = shardings_for(p_axes, p_abs, ctx)
    if opt_cfg.state_format == "int8":
        m_shard = tree_map(lambda a, s: {
            "q": named_sharding(a, s.shape, ctx),
            "s": named_sharding(tuple(a[:-1]) + (None,) if a else (None,),
                                _scale_shape(s.shape), ctx)}, p_axes, p_abs)
    else:
        m_shard = p_shard
    return {"params": p_shard,
            "opt": {"m": m_shard, "v": m_shard, "step": replicated(ctx)}}


def _loss_and_grads(model: LM, params, batch):
    """``(loss, metrics), grads`` of one step's batch: with
    ``cfg.grad_accum > 1``, over that many microbatches of its rows, the
    gradients summed in ``cfg.grad_accum_dtype`` accumulators and averaged,
    the loss and metrics averaged too."""
    ga = model.cfg.grad_accum
    if ga <= 1:
        return value_and_grad(model.loss, params, batch)
    acc_dt = DTYPES[model.cfg.grad_accum_dtype]
    micro = {k: x.reshape(ga, x.shape[0] // ga, *x.shape[1:])
             for k, x in batch.items()}
    gsum = tree_map(lambda p: torch.zeros_like(
        p, dtype=acc_dt, memory_format=torch.contiguous_format), params)
    dev = tree_leaves(params)[0][1].device
    loss = torch.zeros((), dtype=torch.float32, device=dev)
    metrics = {k: torch.zeros((), dtype=torch.float32, device=dev)
               for k in ("ce", "aux", "tokens")}
    for i in range(ga):
        (mb_loss, m), g = value_and_grad(
            model.loss, params, {k: x[i] for k, x in micro.items()})
        gsum = tree_map(lambda a, b: a + b.to(acc_dt), gsum, g)
        loss = loss + mb_loss
        metrics = {k: metrics[k] + m[k] for k in metrics}
    grads = tree_map(lambda g: g / ga, gsum)
    return (loss / ga, {k: x / ga for k, x in metrics.items()}), grads


def make_train_step(model: LM, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss's gradient by ``torch.autograd`` (with
    ``cfg.grad_accum > 1``, over that many microbatches of the batch's rows,
    summed in ``cfg.grad_accum_dtype`` accumulators and averaged, the loss
    and metrics averaged too), then one AdamW update.  ``batch``: tensors on
    the parameters' device
    (:func:`~repro_torch.models.specs.train_batch_specs`).  Metrics: ``ce``,
    ``aux``, ``tokens``, ``lr``, ``grad_norm``, ``loss``, as 0-dim tensors
    (reading one waits for the device)."""
    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict, Dict[str, torch.Tensor]]:
        with obs.span("launch.train_step", device=True):
            (loss, metrics), grads = _loss_and_grads(model, params, batch)
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


# ---------------------------------------------------------------------------
# Steps over a mesh
# ---------------------------------------------------------------------------

def _model_dim(mesh) -> Optional[int]:
    names = list(mesh_shape(mesh))
    return names.index("model") if "model" in names else None


def _step_param(x, where: NamedPlacement):
    """A parameter as the step computes with it: gathered over every mesh
    axis but ``model``, a ``DTensor`` on the ``model`` sub-mesh with the
    leaf's ``model`` placement (on a mesh without a ``model`` axis, the
    whole tensor)."""
    mesh, m = where.mesh, _model_dim(where.mesh)
    keep = tuple(p if i == m else Replicate()
                 for i, p in enumerate(where.placements))
    local = (x.redistribute(mesh, keep).to_local() if isinstance(x, DTensor)
             else local_shard(x, mesh, keep))
    return _on_model(local, where)


def _on_model(local: torch.Tensor, where: NamedPlacement):
    """This rank's part along the ``model`` axis (whole along the others'
    or their rows) as a ``DTensor`` on the ``model`` sub-mesh, placed as
    ``where`` places it there."""
    m = _model_dim(where.mesh)
    if m is None:
        return local
    sub = model_mesh(where.mesh)
    return DTensor.from_local(local, sub, _sub_placements(where, m, sub),
                              run_check=False)


def _sub_placements(where: NamedPlacement, m: int, sub) -> Tuple:
    """``where``'s placement along the ``model`` axis; ``Replicate`` on a
    ``model`` axis of one rank, as ``constrain`` places there."""
    return (where.placements[m],) if sub.size() > 1 else (Replicate(),)


def _model_part(x, where: NamedPlacement) -> torch.Tensor:
    """This rank's part along the ``model`` axis of a step's result (a
    ``DTensor`` on the ``model`` sub-mesh, or a plain tensor every
    ``model`` rank holds alike), as ``where`` places it there."""
    m = _model_dim(where.mesh)
    if m is None:
        return x
    sub = model_mesh(where.mesh)
    return on_model_mesh(x, sub).redistribute(
        sub, _sub_placements(where, m, sub)).to_local()


def _own(x, where: NamedPlacement) -> torch.Tensor:
    """This rank's part of a leaf: a DTensor's local tensor, or its part of
    a tensor every rank holds whole."""
    if isinstance(x, DTensor):
        return x.to_local()
    return local_shard(x, where.mesh, where.placements)


def _placed(tree, shardings):
    """Local parts as DTensors on their placements."""
    return tree_map(lambda x, w: DTensor.from_local(
        x, w.mesh, w.placements, run_check=False), tree, shardings)


def _results(tree, shardings):
    """A serving step's results (their rows, as DTensors on the ``model``
    sub-mesh or plain) as DTensors on their placements over the whole
    mesh."""
    return _placed(tree_map(_model_part, tree, shardings), shardings)


def _rows(x: torch.Tensor, where: NamedPlacement, micro: int = 1
          ) -> torch.Tensor:
    """This rank's rows of a batch leaf that every rank holds whole: with
    ``micro`` microbatches, its part of each (the rows the reference's
    microbatch ``i`` holds are those of the whole batch's)."""
    if micro == 1:
        return local_shard(x, where.mesh, where.placements)
    split = tuple(Shard(p.dim + 1) if isinstance(p, Shard) else p
                  for p in where.placements)
    y = x.reshape(micro, x.shape[0] // micro, *x.shape[1:])
    return local_shard(y, where.mesh, split).reshape(-1, *x.shape[1:])


def _batch_ranks(where: NamedPlacement):
    """The groups of the mesh dims that split the batch's rows (major to
    minor) and their rank count.  A MoE group of the reference may span
    them: ``models.moe`` forms the groups over the whole batch."""
    groups = shard_groups(where.mesh, where.placements, 0)
    return groups, math.prod(dist.get_world_size(g) for g in groups)


def _reduce_grad(g: torch.Tensor, where: NamedPlacement, batch_dims
                 ) -> torch.Tensor:
    """This rank's shard of ``g`` (this rank's part along the ``model``
    axis already) summed over the batch's ranks, mesh dim by mesh dim
    (major to minor): a reduce-scatter along the tensor dim that a batch
    axis also shards the leaf by, an all-reduce over a batch axis that
    leaves the leaf whole, this rank's chunk along a dim split only for the
    leaf by another axis."""
    mesh = where.mesh
    names, coord = list(mesh_shape(mesh)), mesh.get_coordinate()
    for i, p in enumerate(where.placements):
        if names[i] == "model":
            continue
        group = mesh.get_group(names[i])
        if isinstance(p, Shard):
            n = dist.get_world_size(group)
            if i in batch_dims:
                x = g.movedim(p.dim, 0).contiguous()
                part = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
                dist.reduce_scatter_tensor(part, x, group=group)
                g = part.movedim(0, p.dim)
            else:
                size = g.shape[p.dim] // n
                g = g.narrow(p.dim, coord[i] * size, size)
        elif i in batch_dims:
            g = all_reduce(g, (group,))
    return g.contiguous()


def _sharded_norm(grads, shardings) -> torch.Tensor:
    """:func:`~repro_torch.optim.global_norm` of the whole gradient from the
    ranks' shards: each leaf's squares summed on its shard, then over the
    mesh dims that split the leaf (one all-reduce a mesh dim, every leaf at
    once), the leaves added in the reference's order."""
    leaves = tree_leaves(grads)
    where = dict(tree_leaves(shardings))
    sq = torch.stack([torch.sum(torch.square(g.float())) for _, g in leaves])
    mesh = where[leaves[0][0]].mesh
    for i, name in enumerate(mesh_shape(mesh)):
        split = [isinstance(where[k].placements[i], Shard) for k, _ in leaves]
        if any(split):
            split = torch.tensor(split, device=sq.device)
            summed = all_reduce(torch.where(split, sq, 0.0),
                                (mesh.get_group(name),))
            sq = torch.where(split, summed, sq)
    return torch.sqrt(sum(sq.unbind()))


def _train_step(model: LM, opt_cfg: AdamWConfig, shardings, b_shard,
                cell: ShapeCell, ctx: ShardingCtx):
    cfg = model.cfg
    p_shard, opt_shard = shardings["params"], shardings["opt"]
    ga = max(cfg.grad_accum, 1)
    b_where = b_shard["tokens"]
    groups, count = _batch_ranks(b_where)
    batch_dims = {i for i, p in enumerate(b_where.placements)
                  if isinstance(p, Shard)}
    row_max = None
    if opt_cfg.state_format == "int8":
        def reducer(s, w):
            split = shard_groups(w.mesh, w.placements, len(s.shape) - 1)
            return (None if not split else lambda amax: all_reduce(
                amax, split, dist.ReduceOp.MAX))
        row_max = tree_map(reducer, model.abstract_params(), p_shard)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        mine = {k: _rows(x, b_shard[k], ga) for k, x in batch.items()}
        with step_context(ctx), batch_split(groups), \
                batch_reduction(groups, count):
            used = tree_map(_step_param, params, p_shard)
            (loss, metrics), grads = _loss_and_grads(model, used, mine)
            del used
            grads = tree_map(lambda g, w: _reduce_grad(
                _model_part(g, w), w, batch_dims), grads, p_shard)
        norm = _sharded_norm(grads, p_shard)
        new_p, new_s, om = adamw_update(
            opt_cfg, tree_map(_own, params, p_shard), grads,
            tree_map(_own, opt_state, opt_shard), grad_norm=norm,
            row_max=row_max)
        return (_placed(new_p, p_shard), _placed(new_s, opt_shard),
                {**metrics, **om, "loss": loss})
    return train_step


def jitted_cell(cfg: ModelConfig, cell: ShapeCell, ctx: ShardingCtx,
                opt_cfg: Optional[AdamWConfig] = None):
    """``(step, abstract args)`` for one (arch x shape) cell over
    ``ctx.mesh``; every rank of the mesh calls ``step`` with the same
    arguments: parameters (and optimizer state) as DTensors on
    :func:`state_shardings`' placements, or tensors every rank holds whole,
    and the whole batch.  The step runs on this rank's rows of the batch
    (``batch`` -> ``("pod", "data")``) with the loss's sums and the MoE
    statistics taken over every rank's rows, and a MoE layer's groups
    formed over the whole batch's tokens (a group may span ranks: its
    tokens are gathered to the ranks that hold some).  Each parameter is
    gathered over every axis but ``model`` and enters as a ``DTensor`` on
    the ``model`` sub-mesh with its ``model`` placement; the activations
    are redistributed at the reference's ``constrain`` sites, and the
    flash kernels run on each rank's own heads.  Each gradient, taken to
    this rank's ``model`` part, is reduce-scattered over the batch's ranks
    to this rank's shard, and each rank applies AdamW to its own shard (the
    gradient's norm from the shards' squares).  Outputs are DTensors
    (metrics: tensors, the same on every rank).

    ``train``: ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; ``prefill``: ``step(params, batch) -> (logits, cache)``;
    ``decode``: ``step(params, cache, tokens, cache_index) -> (logits,
    cache)``, the cache placed by the cache's logical axes.

    ``step.arg_shardings``: the placements of the abstract arguments, a
    tree parallel to them: parameters (and optimizer state, and a decode
    cache) placed as the step takes them; ``None`` for a leaf every rank
    holds whole (the batch, the tokens, the cache index)."""
    model = LM(cfg)
    p_abs = model.abstract_params()
    logits_shard = named_sharding(
        ("batch", "act_vocab"), (cell.global_batch, cfg.padded_vocab), ctx)

    if cell.kind == "train":
        opt_cfg = opt_cfg or AdamWConfig()
        specs, baxes = train_batch_specs(cfg, cell)
        if opt_cfg.state_format == "int8":
            m_abs = tree_map(lambda s: {
                "q": ShapeDtype(s.shape, torch.int8),
                "s": ShapeDtype(_scale_shape(s.shape), torch.float32)},
                p_abs)
        else:
            m_abs = tree_map(lambda s: ShapeDtype(s.shape, torch.float32),
                             p_abs)
        opt_abs = {"m": m_abs, "v": m_abs,
                   "step": ShapeDtype((), torch.int32)}
        shard = state_shardings(model, opt_cfg, ctx)
        step = _train_step(model, opt_cfg, shard,
                           shardings_for(baxes, specs, ctx), cell, ctx)
        step.arg_shardings = (shard["params"], shard["opt"],
                              {k: None for k in specs})
        return step, (p_abs, opt_abs, specs)

    p_shard = shardings_for(model.param_axes(), p_abs, ctx)
    if cell.kind == "prefill":
        specs, baxes = prefill_batch_specs(cfg, cell)
        b_shard = shardings_for(baxes, specs, ctx)
        cache_defs = model.cache_defs(cell.global_batch, cell.seq_len)
        c_shard = shardings_for(axes_tree(cache_defs),
                                abstract_tree(cache_defs), ctx)
        groups, _ = _batch_ranks(b_shard["tokens"])

        def prefill_step(params, batch):
            with step_context(ctx), batch_split(groups):
                logits, cache = model.prefill(
                    tree_map(_step_param, params, p_shard),
                    {k: _rows(x, b_shard[k]) for k, x in batch.items()})
                return (_results(logits, logits_shard),
                        _results(cache, c_shard))
        prefill_step.arg_shardings = (p_shard, {k: None for k in specs})
        return prefill_step, (p_abs, specs)

    if cell.kind == "decode":
        c_abs, c_axes, tok, tok_axes = decode_specs(cfg, cell)
        c_shard = shardings_for(c_axes, c_abs, ctx)
        t_shard = shardings_for(tok_axes, tok, ctx)["tokens"]
        groups, _ = _batch_ranks(t_shard)

        def decode_step(params, cache, tokens, cache_index):
            if torch.is_tensor(cache_index) and cache_index.dim():
                cache_index = _rows(cache_index, t_shard)  # (B,) index
            with step_context(ctx), batch_split(groups):
                logits, cache = model.decode_step(
                    tree_map(_step_param, params, p_shard),
                    tree_map(lambda x, w: _on_model(_own(x, w), w), cache,
                             c_shard),
                    _rows(tokens, t_shard), cache_index)
                return (_results(logits, logits_shard),
                        _results(cache, c_shard))
        decode_step.arg_shardings = (p_shard, c_shard, None, None)
        return decode_step, (p_abs, c_abs, tok["tokens"],
                             ShapeDtype((), torch.int32))

    raise ValueError(cell.kind)
