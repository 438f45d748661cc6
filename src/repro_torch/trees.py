"""Nested dicts of tensors as trees: the port's ``jax.tree`` helpers, and
the gradient of a function of such a tree.

A tree is a nested dict; anything else is a leaf.  Leaves are visited in
the reference's flattening order (keys sorted, depth first), with paths
that join keys by ``/``.
"""
from __future__ import annotations

from typing import Any, Callable

import torch


def tree_map(fn: Callable[..., Any], tree, *others):
    """``fn`` on every leaf of a nested dict (a ``ParamDef``, a
    tensor: anything but a dict) and the nodes at the same place in
    ``others``; same structure."""
    if not isinstance(tree, dict):
        return fn(tree, *others)
    return {k: tree_map(fn, v, *(o[k] for o in others))
            for k, v in tree.items()}


def tree_leaves(tree, prefix: str = ""):
    """``[(path, leaf)]`` of a nested dict in the reference's flattening
    order (keys sorted, depth first); paths join keys with ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += tree_leaves(tree[k], f"{prefix}/{k}" if prefix else k)
    return out


def tree_unflatten(node, flat, prefix=""):
    """``node``'s structure with its leaves taken from ``flat``, a dict by
    :func:`tree_leaves` path.  A module-level function, not a closure: a
    nested function that calls itself is a reference cycle, which would
    keep every tensor of ``flat`` alive until the garbage collector ran,
    even after a caller replaced them (a full-width model cast to float32
    leaf by leaf would hold both copies)."""
    if not isinstance(node, dict):
        return flat[prefix]
    return {k: tree_unflatten(v, flat, f"{prefix}/{k}" if prefix else k)
            for k, v in node.items()}


def value_and_grad(fn: Callable, params, *args):
    """``fn(params, *args)`` and its gradient with respect to every leaf of
    ``params`` (each leaf taken as a fresh autograd leaf; zero for a leaf
    the value does not reach, as ``jax.grad`` gives), in the leaves' types.
    ``fn`` returns the value or ``(value, aux)``, a dict of tensors; both
    come back detached, in the same form."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    paths, flat = zip(*tree_leaves(leaves))
    out = fn(leaves, *args)
    value = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(value, flat, allow_unused=True,
                                materialize_grads=True)
    out = ((value.detach(), tree_map(torch.Tensor.detach, out[1]))
           if isinstance(out, tuple) else value.detach())
    return out, tree_unflatten(leaves, dict(zip(paths, grads)))
