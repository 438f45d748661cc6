"""Logical-axis sharding: one rule table maps model-level axis names onto
mesh axes (DP/FSDP/TP/SP/EP), with automatic divisibility fallback.

Models and launchers name their dims *logically*; :func:`spec_for`
resolves the names on a mesh (any object whose ``.shape`` is a dict of axis
sizes, or a ``torch.distributed`` ``DeviceMesh``) into a spec with the
reference's ``PartitionSpec`` entries, and :func:`placements_for` turns a
spec into ``DTensor`` placements.  Outside a :func:`sharding_context` every
constraint is a no-op, so the same model code runs on one device.

The ``model`` mesh axis is carried by ``DTensor``s on the 1-D sub-mesh
``mesh["model"]`` (:func:`model_mesh`): :func:`constrain` redistributes an
activation to the ``model`` entry of its spec, the reference's
``with_sharding_constraint``.  The batch axes are not: each rank holds its
own rows as plain tensors (the ``model`` ranks of one batch group hold the
same ones), and the sums over them are explicit (below).

The ``batch_sum`` family stands in for what one SPMD program over the
whole batch gives the reference: inside a :func:`batch_reduction` it sums a
rank's term over the ranks that hold the other rows, and passes the
gradient to this rank's own term unchanged, so the sum of the ranks'
gradients is the gradient of the global quantity.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

# Logical axis -> tuple of mesh axes.  'pod' only exists on the multi-pod
# mesh; missing mesh axes are dropped at resolution time.
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    # parameter axes
    "embed": ("data",),        # FSDP (ZeRO-3) over the data axis
    "vocab": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "mlp": ("model",),
    "expert": ("model",),
    "ssm_inner": ("model",),
    "conv_dim": ("model",),
    # activation axes
    "batch": ("pod", "data"),
    "seq": ("model",),         # sequence parallelism on the residual stream
    "act_heads": ("model",),
    "kv_seq": ("model",),      # decode KV-cache sequence sharding
    "act_vocab": ("model",),
    "act_expert": ("model",),
}

@dataclasses.dataclass
class ShardingCtx:
    mesh: Any
    rules: Dict[str, Tuple[str, ...]]


class NamedPlacement(NamedTuple):
    """The port's ``NamedSharding``: DTensor placements on a mesh."""
    mesh: Any
    placements: Tuple


_TLS = threading.local()


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[Dict[str, Tuple[str, ...]]] = None):
    """Bind ``mesh`` and a rule table for this thread."""
    prev = current_ctx()
    _TLS.ctx = ShardingCtx(mesh, dict(rules or DEFAULT_RULES))
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def step_context(ctx: ShardingCtx):
    """What a step over ``ctx.mesh`` runs its model in: ``ctx`` bound (so
    :func:`constrain` places), and ``DTensor``'s implicit replication of
    plain tensors, which are the rows and constants that every ``model``
    rank of a batch group holds alike."""
    with sharding_context(ctx.mesh, ctx.rules), implicit_replication():
        yield


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in the mesh's dim order."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, (int(n) for n in mesh.shape)))


def _resolve_dim(name: Optional[str], size: int, mesh,
                 rules: Dict[str, Tuple[str, ...]]):
    """Mesh axes for one logical dim; falls back to replication when the
    dim size does not divide the mesh extent (e.g. 14 heads on 16-way TP)."""
    if name is None:
        return None
    shape = mesh_shape(mesh)
    axes = tuple(a for a in rules.get(name, ()) if a in shape)
    if not axes:
        return None
    extent = math.prod(shape[a] for a in axes)
    if size % extent != 0:
        # try a prefix of the axes (e.g. drop 'data' keep 'pod')
        for end in range(len(axes) - 1, 0, -1):
            sub = axes[:end]
            if size % math.prod(shape[a] for a in sub) == 0:
                return sub if len(sub) > 1 else sub[0]
        return None
    return axes if len(axes) > 1 else axes[0]


def spec_for(logical: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Dict[str, Tuple[str, ...]]) -> Tuple:
    """One entry per dim: ``None``, a mesh axis name, or a tuple of names
    (the reference's ``PartitionSpec`` entries)."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} vs shape {shape}")
    used = set()
    parts = []
    for name, size in zip(logical, shape):
        r = _resolve_dim(name, size, mesh, rules)
        # a mesh axis may appear at most once in a spec
        if r is not None:
            axes = (r,) if isinstance(r, str) else tuple(r)
            if any(a in used for a in axes):
                r = None
            else:
                used.update(axes)
        parts.append(r)
    return tuple(parts)


def placements_for(spec: Sequence, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim: a mesh
    dim named by the spec's entry for tensor dim ``d`` is ``Shard(d)``, an
    unnamed one ``Replicate()``.

    A dim split over several mesh axes is split major to minor in the
    order the spec names them (JAX's rule); DTensor splits it in mesh-dim
    order.  The two agree only when the spec names the axes in mesh-dim
    order, which is checked."""
    names = list(mesh_shape(mesh))
    placements = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        axes = (part,) if isinstance(part, str) else tuple(part)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {part} names mesh axes out of the "
                             f"mesh's order {names}: DTensor would split "
                             "the dim in another order than JAX")
        for i in idx:
            placements[i] = Shard(dim)
    return tuple(placements)


def model_mesh(mesh):
    """The 1-D sub-mesh of ``mesh``'s ``model`` axis (``None`` where the
    mesh has none), made once per mesh."""
    if "model" not in mesh_shape(mesh):
        return None
    sub = getattr(mesh, "_repro_model_mesh", None)
    if sub is None:
        sub = mesh["model"]
        mesh._repro_model_mesh = sub
    return sub


def model_placement(spec: Sequence, sub) -> Tuple:
    """The placements on the ``model`` sub-mesh ``sub`` of ``spec``:
    ``(Shard(d),)`` where the spec names ``model`` for dim ``d``, else
    ``(Replicate(),)``, which it also is on a sub-mesh of one rank (where
    both hold the whole tensor, and DTensor refuses some views of a
    ``Shard``); the batch axes are left to the rows each rank holds."""
    if sub.size() == 1:
        return (Replicate(),)
    for dim, part in enumerate(spec):
        if part == "model" or (isinstance(part, tuple) and "model" in part):
            return (Shard(dim),)
    return (Replicate(),)


def on_model_mesh(x: torch.Tensor, sub) -> DTensor:
    """``x`` as a DTensor on the ``model`` sub-mesh ``sub``: a plain tensor
    (which every ``model`` rank of the batch group holds alike) as
    replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, sub, (Replicate(),), run_check=False)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` by logical names: a
    no-op outside a context and on a mesh without a ``model`` axis;
    otherwise ``x`` (made a DTensor on the ``model`` sub-mesh, replicated,
    where it is a plain tensor) redistributed to the ``model`` entry of
    :func:`spec_for` on the whole mesh.  At a ``model`` extent of 1 it
    still runs, and moves nothing."""
    ctx = current_ctx()
    if ctx is None:
        return x
    sub = model_mesh(ctx.mesh)
    if sub is None:
        return x
    want = model_placement(spec_for(logical, x.shape, ctx.mesh, ctx.rules),
                           sub)
    x = on_model_mesh(x, sub)
    return x if tuple(x.placements) == want else x.redistribute(sub, want)


def unflatten(x: torch.Tensor, dim: int, sizes: Sequence[int]
              ) -> torch.Tensor:
    """``x.unflatten(dim, sizes)``.  A DTensor split along ``dim`` into
    parts that the first of ``sizes`` does not split into (14 heads on a
    4-way ``model`` axis) is made whole along it first, as GSPMD moves
    it."""
    dim %= x.dim()
    if isinstance(x, DTensor) and sizes[0] % x.device_mesh.size() and any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in x.placements))
    return x.unflatten(dim, sizes)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """``(..., heads, D) -> (..., heads * D)``.  For a DTensor whose heads
    do not split evenly over its mesh, the gradient is pinned to ``x``'s
    placements before the view's backward, which could not split a
    gradient that arrives split along ``heads * D`` back into heads."""
    y = x.flatten(-2)
    if not isinstance(x, DTensor):
        return y
    if x.shape[-2] % x.device_mesh.size():
        y = y.redistribute(y.device_mesh, y.placements)
    if all(p.is_replicate() for p in y.placements):
        # DTensor derives the view's strides anew, and on a size-1 dim (a
        # decode step's one position) they can differ from its local
        # tensor's: ATen's matmul then takes a batched product where the
        # plain tensor takes one mm, and rounds otherwise.  A replicated
        # DTensor's local tensor is the whole one: its strides are restored.
        local = y.to_local()
        y = DTensor.from_local(local, y.device_mesh, y.placements,
                               run_check=False, shape=local.shape,
                               stride=local.stride())
    return y


def settled(x: torch.Tensor) -> torch.Tensor:
    """``x`` with a pending sum carried out: a DTensor's ``Partial``
    placements (a gather or an embedding over a vocab split on the
    ``model`` axis leaves each rank its own entries) made ``Replicate``,
    before an op that is not linear."""
    if isinstance(x, DTensor) and any(p.is_partial() for p in x.placements):
        return x.redistribute(x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
    return x


def whole_reshape(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``.  A DTensor is replicated on its mesh first,
    and its gradient made whole before the reshape's backward: DTensor
    cannot follow a reshape that merges a split dim into one before it,
    nor split a split dim into sizes the mesh does not divide."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    mesh, whole = x.device_mesh, (Replicate(),) * x.device_mesh.ndim
    y = x.redistribute(mesh, whole).reshape(*shape)
    return y.redistribute(mesh, whole)


class _GradAsForward(torch.autograd.Function):
    """The identity; its backward hands the gradient on placed as the
    forward's tensor was (a pending sum's gradient whole)."""

    @staticmethod
    def forward(ctx, y):
        ctx.placements = tuple(Replicate() if p.is_partial() else p
                               for p in y.placements)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        if isinstance(grad, DTensor) and \
                tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad


def grad_as_forward(y: torch.Tensor) -> torch.Tensor:
    """``y``; on a mesh of more than one rank, its gradient is placed as
    ``y`` is before the op that made ``y`` takes it (torch releases before
    2.13 refuse to split or fold a dim of a gradient split otherwise)."""
    if _split_mesh(y) is None:
        return y
    return _GradAsForward.apply(y)


class _Cumsum(torch.autograd.Function):
    """``torch.cumsum`` whose backward (the gradient's sum from the end)
    runs on the rank's part: the dim it sums along is not split."""

    @staticmethod
    def forward(ctx, x, dim: int):
        ctx.dim, ctx.placements = dim, x.placements
        return torch.cumsum(x, dim)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != tuple(ctx.placements):
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        d = ctx.dim
        local = grad.to_local().flip(d).cumsum(d).flip(d)
        return DTensor.from_local(local, grad.device_mesh, grad.placements,
                                  run_check=False, shape=grad.shape,
                                  stride=grad.stride()), None


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cumsum(x, dim)`` (``dim`` non-negative: DTensor's cumsum with
    a negative dim on a split dim sums each rank's part alone).  For a
    DTensor on a mesh of more than one rank that does not split ``dim``,
    the backward's flips run on the rank's part: torch releases before
    2.13 have no DTensor rule for ``flip``."""
    if _split_mesh(x) is None or any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        return torch.cumsum(x, dim)
    return _Cumsum.apply(x, dim)


def _split_mesh(*tensors):
    """The mesh of the first DTensor among ``tensors`` if it has more than
    one rank, else ``None``."""
    for t in tensors:
        if isinstance(t, DTensor):
            return t.device_mesh if t.device_mesh.size() > 1 else None
    return None


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for an activation ``x`` ``(..., K)`` and a weight ``w``
    ``(K, N)``, by the plan DTensor itself takes, spelled out where the
    torch releases before 2.13 refuse it.  ATen's matmul folds ``x``'s
    leading dims into one (and unfolds the result's gradient), and those
    releases cannot fold a dim split over the mesh that is not the first:
    so with ``x`` split along a dim between its first and its last (the
    sequence) and ``w`` whole, each rank multiplies its parts (``x``'s
    placement kept, ``w``'s gradient a pending sum); with ``w`` split,
    ``x`` is gathered first; and the result's gradient is placed as the
    result was before the product's backward takes it.  On a mesh of one
    rank, ``x @ w``."""
    if x.dim() <= 2 or _split_mesh(x, w) is None:
        return x @ w
    middle = isinstance(x, DTensor) and any(
        isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
        for p in x.placements)
    if middle and isinstance(w, DTensor) and all(
            p.is_replicate() for p in w.placements) and all(
            isinstance(p, (Shard, Replicate)) for p in x.placements):
        pending = tuple(Partial() if isinstance(p, Shard) else Replicate()
                        for p in x.placements)
        shape = (*x.shape[:-1], w.shape[-1])
        return DTensor.from_local(
            x.to_local() @ w.to_local(grad_placements=pending),
            x.device_mesh, x.placements, run_check=False, shape=shape,
            stride=torch.empty(shape, device="meta").stride())
    if middle:
        x = x.redistribute(x.device_mesh, tuple(
            Replicate() if isinstance(p, Shard) and 0 < p.dim < x.dim() - 1
            else p for p in x.placements))
    return grad_as_forward(x @ w)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(equation, *operands)``, spelled out as DTensor's own
    plan where an operand is a DTensor split along some dim: per mesh dim,
    the letter the largest operand is split along stays split in every
    operand that has it (the others are gathered), the local einsum runs,
    and the result is split along that letter (an operand without it
    takes a pending sum as its gradient).  ATen's einsum folds dims into
    batched products, and torch releases before 2.13 cannot fold a split
    dim that is not the first of those it folds: they refuse the view.
    Plain ``torch.einsum`` where no operand is split, or where the letter
    is summed over."""
    split = [i for i, x in enumerate(operands) if isinstance(x, DTensor)
             and any(isinstance(p, Shard) for p in x.placements)]
    if not split:
        return torch.einsum(equation, *operands)
    inputs, output = equation.replace(" ", "").split("->")
    subs = inputs.split(",")
    mesh = operands[split[0]].device_mesh
    ops = [x if isinstance(x, DTensor) else DTensor.from_local(
        x, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        for x in operands]
    if any(x.device_mesh != mesh
           or any(p.is_partial() for p in x.placements) for x in ops):
        return torch.einsum(equation, *operands)
    big = max(split, key=lambda i: operands[i].numel())
    letters = [subs[big][p.dim] if isinstance(p, Shard) else None
               for p in ops[big].placements]
    if any(c is not None and c not in output for c in letters):
        return torch.einsum(equation, *operands)
    placed, grads = [], []
    for x, sub in zip(ops, subs):
        want = tuple(Shard(sub.index(c)) if c is not None and c in sub
                     else Replicate() for c in letters)
        placed.append(x.redistribute(mesh, want)
                      if tuple(x.placements) != want else x)
        grads.append(tuple(Partial() if c is not None and c not in sub
                           else w for c, w in zip(letters, want)))
    local = torch.einsum(equation, *(x.to_local(grad_placements=g)
                                     for x, g in zip(placed, grads)))
    size = {c: n for x, sub in zip(ops, subs) for c, n in zip(sub, x.shape)}
    shape = tuple(size[c] for c in output)
    return DTensor.from_local(
        local, mesh, tuple(Shard(output.index(c)) if c is not None
                           else Replicate() for c in letters),
        run_check=False, shape=shape,
        stride=torch.empty(shape, device="meta").stride())


def named_sharding(logical: Sequence[Optional[str]], shape: Sequence[int],
                   ctx: Optional[ShardingCtx] = None) -> NamedPlacement:
    ctx = ctx or current_ctx()
    if ctx is None:
        raise ValueError("named_sharding requires a sharding context")
    return NamedPlacement(ctx.mesh, placements_for(
        spec_for(logical, shape, ctx.mesh, ctx.rules), ctx.mesh))


# ---------------------------------------------------------------------------
# A rank's part of a placed tensor
# ---------------------------------------------------------------------------

def shard_bounds(shape: Sequence[int], sizes: Sequence[int],
                 placements: Sequence, coordinate: Sequence[int]
                 ) -> Tuple[Tuple[int, int], ...]:
    """``(start, stop)`` per tensor dim of the part held at ``coordinate``
    of a mesh of ``sizes``: each ``Shard(d)`` splits dim ``d`` evenly, the
    mesh dims in order (major to minor)."""
    bounds = [[0, int(n)] for n in shape]
    for size, p, c in zip(sizes, placements, coordinate):
        if isinstance(p, Shard):
            lo, hi = bounds[p.dim]
            if (hi - lo) % size:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split evenly {size} ways")
            step = (hi - lo) // size
            bounds[p.dim] = [lo + c * step, lo + (c + 1) * step]
        elif not isinstance(p, Replicate):
            raise ValueError(f"unsupported placement {p}")
    return tuple((lo, hi) for lo, hi in bounds)


def local_shard(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of ``full`` (which every rank holds whole)."""
    coord = mesh.get_coordinate()
    out = full
    for dim, (lo, hi) in enumerate(shard_bounds(full.shape, mesh.shape,
                                                placements, coord)):
        if (lo, hi) != (0, full.shape[dim]):
            out = out.narrow(dim, lo, hi - lo)
    return out.contiguous()


def place(full: torch.Tensor, where: NamedPlacement) -> DTensor:
    """A DTensor from a tensor that every rank holds whole: each rank
    keeps its own part, nothing is sent."""
    return DTensor.from_local(
        local_shard(full, where.mesh, where.placements), where.mesh,
        where.placements, run_check=False, shape=full.shape,
        stride=full.contiguous().stride())


def gather(x):
    """The whole tensor: a DTensor's ``full_tensor()`` (a collective: every
    rank of its mesh calls it), anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def shard_groups(mesh, placements, dim: int) -> Tuple:
    """The process groups of the mesh dims that split tensor dim ``dim``,
    in mesh order."""
    names = list(mesh_shape(mesh))
    return tuple(mesh.get_group(names[i]) for i, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim == dim)


def all_reduce(x: torch.Tensor, groups: Sequence, op=dist.ReduceOp.SUM
               ) -> torch.Tensor:
    """``x`` reduced over each group in turn (a new, contiguous tensor)."""
    x = x.clone(memory_format=torch.contiguous_format)
    for g in groups:
        dist.all_reduce(x, op=op, group=g)
    return x


# ---------------------------------------------------------------------------
# Global quantities of a batch split over ranks
# ---------------------------------------------------------------------------

class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum over ``groups``.  Backward: the gradient to this
    rank's own term unchanged; every rank computes the same function of the
    sum, so summing the ranks' gradients afterwards counts it once."""

    @staticmethod
    def forward(ctx, x, groups):
        return all_reduce(x, groups)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def sum_over_ranks(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    return _SumOverRanks.apply(x, tuple(groups))


# The batch_reduction in force, ``(groups, count)`` or ``None``.  Held for
# the process, not per thread: autograd runs a CUDA graph's backward, and so
# the recompute of a checkpointed layer (``LM._remat``), on a device worker
# thread, which must reduce the same way as the forward did.
_BATCH: Optional[Tuple[Tuple, int]] = None


@contextlib.contextmanager
def batch_reduction(groups: Sequence, count: int):
    """Within it, on every thread (the backward pass included),
    :func:`batch_sum` and :func:`batch_mean` reduce over ``groups``, the
    ``count`` ranks that hold the batch's rows."""
    global _BATCH
    prev, _BATCH = _BATCH, (tuple(groups), count)
    try:
        yield
    finally:
        _BATCH = prev


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch's ranks (``x`` outside a
    :func:`batch_reduction`).  A DTensor on the ``model`` sub-mesh is
    made whole first: the ``model`` ranks hold the same rows, so the sum
    runs over the batch's ranks only, never over them."""
    x = gather(x)
    return x if _BATCH is None else sum_over_ranks(x, _BATCH[0])


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over the batch's ranks of a mean over equal parts (a
    DTensor made whole first, as in :func:`batch_sum`)."""
    x = gather(x)
    return x if _BATCH is None else sum_over_ranks(x, _BATCH[0]) / _BATCH[1]


# ---------------------------------------------------------------------------
# The batch's rows over its ranks
# ---------------------------------------------------------------------------

# The groups of the mesh dims that split the batch's rows in a step over a
# mesh, major to minor (``()`` outside one).  Held for the process, as
# ``_BATCH`` is: a checkpointed layer's recompute reads it too.
_ROWS: Tuple = ()


@contextlib.contextmanager
def batch_split(groups: Sequence):
    """Within it, on every thread, the batch's rows are split over
    ``groups`` (the mesh dims' process groups, major to minor): rank ``r``
    of them (:func:`batch_rank`) holds the ``r``-th equal run of the rows.
    A MoE layer routes its groups of tokens over the whole batch's."""
    global _ROWS
    prev, _ROWS = _ROWS, tuple(groups)
    try:
        yield
    finally:
        _ROWS = prev


def batch_rank() -> Tuple[int, int]:
    """``(this rank's index, the rank count)`` over the batch's ranks
    (``(0, 1)`` outside a :func:`batch_split`)."""
    index, count = 0, 1
    for g in _ROWS:
        n = dist.get_world_size(g)
        index, count = index * n + dist.get_rank(g), count * n
    return index, count


class _GatherRows(torch.autograd.Function):
    """Forward: the rows of every rank of ``groups``, in the batch's order
    (gathered over the minor dim first).  Backward: each rank's gradient
    for the rows summed and this rank's own rows kept (reduce-scattered
    over the major dim first)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for g in reversed(groups):
            out = x.new_empty((dist.get_world_size(g) * x.shape[0],)
                              + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x.contiguous(), group=g)
            x = out
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        for g in ctx.groups:
            part = grad.new_empty((grad.shape[0] // dist.get_world_size(g),)
                                  + tuple(grad.shape[1:]))
            dist.reduce_scatter_tensor(part, grad, group=g)
            grad = part
        return grad, None


def gather_batch_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` (this rank's rows along dim 0) with every batch rank's rows,
    in the batch's order; its gradient goes back as the sum over the ranks
    of their gradients for this rank's rows.  A DTensor on the ``model``
    sub-mesh (whole along dim 0: the ``model`` ranks of a batch group hold
    the same rows) gathers its local tensor and keeps its placements."""
    groups = tuple(g for g in _ROWS if dist.get_world_size(g) > 1)
    if not groups:
        return x
    if isinstance(x, DTensor):
        return DTensor.from_local(_GatherRows.apply(x.to_local(), groups),
                                  x.device_mesh, x.placements,
                                  run_check=False)
    return _GatherRows.apply(x, groups)
